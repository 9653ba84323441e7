"""Deficit-round-robin tenant queue for the shared verify plane — a copy
of handel_tpu/service/fairness.py.

The single-tenant `BatchVerifierService` drained one FIFO list, which is
exactly wrong under multi-session load: one hot session (a flooded or very
large committee) enqueues faster than the collector drains and every other
session's candidates age behind its backlog. `TenantQueue` keeps one FIFO
per session and serves them deficit-round-robin [Shreedhar & Varghese '96,
degenerate unit-cost form — every verify candidate costs one launch lane]:
each tenant at the head of the active ring is charged `quantum` lane
credits per visit, spends them on its own candidates, and rotates to the
tail, so a full ring pass hands every backlogged session `quantum` lanes no
matter how deep any one backlog is. An emptied tenant forfeits its residual
deficit (no credit hoarding across idle periods — the standard DRR rule).

Per-tenant admission bound: `push` refuses beyond `max_pending` queued
items for one tenant, so a hot session's backlog is ITS problem — the
refusal surfaces to that session's caller (the processing pipeline's
retry/requeue budget) instead of growing host memory or the ring latency
every other tenant pays.

SLO-driven admission (the lifecycle control plane): each tenant
carries an `SloTier` — a priority weight that scales its DRR quantum (a
gold tenant earns `weight ×` lane credits per ring visit) plus a
load-shedding threshold expressed as a fraction of the queue's GLOBAL
`capacity`. When total depth crosses a tier's `shed_at` fraction, NEW work
for that tier is refused at the door — bronze sheds first, gold last — so
an overloaded plane spends its lanes meeting the strictest p99 targets
instead of degrading everyone equally. The flat per-tenant `max_pending`
bound stays as the fallback flood-defense knob; `capacity = 0` disables
shedding entirely (the pre-SLO behavior, byte for byte).

Single-threaded like the service it fronts (core/store.py module
docstring): every caller runs on one asyncio loop, so no lock.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Iterator

DEFAULT_QUANTUM = 8
DEFAULT_MAX_PENDING = 4096


@dataclass(frozen=True)
class SloTier:
    """One admission/priority class. `weight` multiplies the tenant's DRR
    quantum; `p99_target_s` is the session-completion SLO the manager
    reports against (service/session.py tier_quantiles in the reference);
    `shed_at` is the fraction of queue capacity past which this tier's new
    work sheds."""

    name: str
    weight: int = 1
    p99_target_s: float = 30.0
    shed_at: float = 1.0


#: the built-in tier ladder; tenants without an explicit tier ride
#: "standard" (weight 1, shed only at full capacity — legacy behavior)
TIERS = {
    "gold": SloTier("gold", weight=4, p99_target_s=5.0, shed_at=0.98),
    "silver": SloTier("silver", weight=2, p99_target_s=15.0, shed_at=0.85),
    "bronze": SloTier("bronze", weight=1, p99_target_s=60.0, shed_at=0.60),
    "standard": SloTier("standard", weight=1, p99_target_s=30.0, shed_at=1.0),
}
DEFAULT_TIER = TIERS["standard"]


class TenantQueue:
    """Per-tenant FIFOs drained fairly, `quantum` lanes per ring visit."""

    def __init__(
        self,
        quantum: int = DEFAULT_QUANTUM,
        max_pending: int = DEFAULT_MAX_PENDING,
        capacity: int = 0,
    ):
        if quantum < 1:
            raise ValueError("quantum must be >= 1")
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.quantum = quantum
        self.max_pending = max_pending
        # global depth bound for SLO shedding; 0 = shedding off
        self.capacity = capacity
        self._q: dict[str, deque] = {}
        self._ring: deque[str] = deque()  # tenants with queued work
        self._deficit: dict[str, int] = {}
        self._tier: dict[str, SloTier] = {}
        self._total = 0  # queued items across tenants (O(1) shed check)
        # reporter counters
        self.pushed = 0
        self.refused = 0
        self.shed = 0
        self.taken = 0

    def set_tier(self, tenant: str, tier: SloTier | str) -> SloTier:
        """Pin one tenant's admission/priority class ("gold"/"silver"/
        "bronze"/"standard", or a custom SloTier)."""
        if isinstance(tier, str):
            tier = TIERS[tier]
        self._tier[tenant] = tier
        return tier

    def tier_of(self, tenant: str) -> SloTier:
        return self._tier.get(tenant, DEFAULT_TIER)

    def drop_tier(self, tenant: str) -> None:
        self._tier.pop(tenant, None)

    def push(self, tenant: str, item) -> bool:
        """Enqueue one item for `tenant`; False = refused (the item was
        NOT queued — the caller owns the refusal). Two doors: the tier's
        load-shed threshold against GLOBAL depth, then the flat per-tenant
        bound."""
        if self.capacity > 0:
            tier = self.tier_of(tenant)
            if self._total >= self.capacity * tier.shed_at:
                self.shed += 1
                return False
        q = self._q.get(tenant)
        if q is None:
            q = self._q[tenant] = deque()
            self._ring.append(tenant)
            self._deficit[tenant] = 0
        if len(q) >= self.max_pending:
            self.refused += 1
            return False
        q.append(item)
        self._total += 1
        self.pushed += 1
        return True

    def shed_rate(self) -> float:
        """Shed pushes over everything offered (the soak SLO metric)."""
        offered = self.pushed + self.refused + self.shed
        return self.shed / offered if offered else 0.0

    def take(self, lanes: int) -> list:
        """Dequeue up to `lanes` items across tenants, deficit-round-robin.

        The head tenant keeps its position (and residual deficit) when the
        lane budget runs out mid-quantum, so fairness holds ACROSS calls:
        a launch boundary never resets whose turn it is.
        """
        out: list = []
        while lanes > 0 and self._ring:
            t = self._ring[0]
            q = self._q[t]
            d = self._deficit[t]
            if d <= 0:
                # tier weight scales the per-visit credit: a gold tenant
                # earns weight× lanes per ring pass (priority share)
                self._deficit[t] = d = (
                    self.quantum * self.tier_of(t).weight
                )
            k = min(d, len(q), lanes)
            for _ in range(k):
                out.append(q.popleft())
            self._total -= k
            self._deficit[t] = d - k
            lanes -= k
            if not q:
                # emptied: off the ring, residual deficit forfeited
                del self._q[t]
                self._ring.popleft()
                del self._deficit[t]
            elif self._deficit[t] == 0:
                self._ring.rotate(-1)  # quantum spent: next tenant's turn
            else:
                break  # lane budget exhausted mid-quantum: resume here
        self.taken += len(out)
        return out

    def drop_tenant(self, tenant: str) -> list:
        """Remove one tenant's whole queue (session evict); returns the
        dropped items so the caller can fail their waiters."""
        self.drop_tier(tenant)
        q = self._q.pop(tenant, None)
        if q is None:
            return []
        self._total -= len(q)
        self._deficit.pop(tenant, None)
        try:
            self._ring.remove(tenant)
        except ValueError:
            pass
        return list(q)

    def drain(self) -> Iterator:
        """Remove and yield every queued item (service stop())."""
        for t in list(self._q):
            yield from self.drop_tenant(t)

    def depth(self, tenant: str) -> int:
        q = self._q.get(tenant)
        return len(q) if q is not None else 0

    def depths(self) -> dict[str, int]:
        """Per-tenant queue depths (the `session`-labeled gauge surface)."""
        return {t: len(q) for t, q in self._q.items()}

    def tenants(self) -> int:
        return len(self._q)

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())
