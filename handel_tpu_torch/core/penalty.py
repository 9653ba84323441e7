"""Per-peer penalty scoring: demote and ban misbehaving origins — a copy of
handel_tpu/core/penalty.py (`PeerScorer`, and `SessionScorers` for the
service's sessions).

The reference has no peer accounting at all — a byzantine peer can feed
invalid signatures forever and every one costs the receiver a pairing check
(processing.go:282-284 just logs and moves on). Here every failed
verification (and, at lower weight, every unparseable packet) is attributed
back to the packet origin; the origin accumulates a decaying penalty score
that first demotes it in `Level.select_next_peers` (half the outbound
updates) and then bans it outright (inbound packets dropped at
`Handel._validate_packet`, before any signature parsing).

Decay is exponential with a configurable half-life, so a peer that hiccuped
once (a corrupting link) recovers, while a persistent invalid-signer
crosses the ban threshold and stays there.
The ban set is bounded: scores are keyed by registry id (already
range-checked by packet validation, so spoofed origins cannot grow it), and
the ban set refuses growth past `ban_capacity` — an adversary cannot turn
the penalty layer itself into a memory attack.

Single-threaded like the rest of the protocol plane (core/store.py module
docstring): every caller runs on one asyncio loop, so no lock.
"""

from __future__ import annotations

import time
from typing import Callable

DEFAULT_DEMOTE_THRESHOLD = 3.0
DEFAULT_BAN_THRESHOLD = 8.0
DEFAULT_HALF_LIFE_S = 10.0
DEFAULT_BAN_CAPACITY = 256

# attribution weights: a failed pairing check is strong evidence (honest
# nodes only forward verified content), an unparseable packet is weaker
# (cheap to produce, and a corrupting link blames an honest sender)
WEIGHT_VERIFY_FAIL = 1.0
WEIGHT_PARSE_FAIL = 0.25


class PeerScorer:
    """Decaying per-peer penalty scores with a bounded ban set."""

    def __init__(
        self,
        demote_threshold: float = DEFAULT_DEMOTE_THRESHOLD,
        ban_threshold: float = DEFAULT_BAN_THRESHOLD,
        half_life_s: float = DEFAULT_HALF_LIFE_S,
        ban_capacity: int = DEFAULT_BAN_CAPACITY,
        clock: Callable[[], float] = time.monotonic,
    ):
        if demote_threshold <= 0 or ban_threshold <= 0:
            raise ValueError("penalty thresholds must be > 0")
        if ban_threshold < demote_threshold:
            raise ValueError("ban threshold must be >= demote threshold")
        self.demote_threshold = demote_threshold
        self.ban_threshold = ban_threshold
        self.half_life_s = half_life_s
        self.ban_capacity = ban_capacity
        self.clock = clock
        self._scores: dict[int, tuple[float, float]] = {}  # id -> (score, ts)
        self._banned: set[int] = set()
        # reporter counters
        self.reports = 0
        self.ban_refused = 0

    def _decayed(self, peer: int, now: float) -> float:
        entry = self._scores.get(peer)
        if entry is None:
            return 0.0
        score, ts = entry
        if self.half_life_s > 0 and now > ts:
            score *= 0.5 ** ((now - ts) / self.half_life_s)
        return score

    def report(self, peer: int, weight: float = WEIGHT_VERIFY_FAIL) -> None:
        """Attribute one offense of the given weight to `peer`."""
        now = self.clock()
        score = self._decayed(peer, now) + weight
        self._scores[peer] = (score, now)
        self.reports += 1
        if score >= self.ban_threshold and peer not in self._banned:
            if len(self._banned) < self.ban_capacity:
                self._banned.add(peer)
            else:
                self.ban_refused += 1

    def score(self, peer: int) -> float:
        return self._decayed(peer, self.clock())

    def demoted(self, peer: int) -> bool:
        """Penalized enough to receive only every other outbound update."""
        return (
            peer not in self._banned
            and self.score(peer) >= self.demote_threshold
        )

    def banned(self, peer: int) -> bool:
        return peer in self._banned

    def values(self) -> dict[str, float]:
        """Reporter counters: reports, bans, refused bans."""
        return {
            "peerPenaltyReports": float(self.reports),
            "peersBanned": float(len(self._banned)),
            "peerBanRefused": float(self.ban_refused),
        }

    def gauge_keys(self) -> set[str]:
        """The ban-set size is a level, not an event count."""
        return {"peersBanned"}


class SessionScorers:
    """Per-tenant penalty state for the multi-tenant service.

    One aggregation session is one trust domain: a peer that misbehaves in
    session A earned its penalty against A's committee, not against every
    committee this process will ever host — and a retired session's scores
    must not linger as host memory or stale bans. This registry keys one
    `PeerScorer` per session id; `drop` (the SessionManager evict hook)
    removes a tenant's whole penalty footprint in one call, and the
    registry itself is bounded: past `capacity` live scorers the
    least-recently-touched one is evicted, so session-id churn cannot turn
    the penalty layer into a memory attack (the same argument as
    PeerScorer's own ban_capacity).

    Single-threaded like PeerScorer (module docstring): no lock.
    """

    def __init__(
        self,
        factory: Callable[[], PeerScorer] = PeerScorer,
        capacity: int = 256,
    ):
        if capacity < 1:
            raise ValueError("scorer capacity must be >= 1")
        self.factory = factory
        self.capacity = capacity
        self._scorers: dict[str, PeerScorer] = {}  # insertion = recency
        self.evicted = 0

    def for_session(self, session: str) -> PeerScorer:
        """The session's scorer, created on first use (LRU-touched)."""
        sc = self._scorers.pop(session, None)
        if sc is None:
            sc = self.factory()
            while len(self._scorers) >= self.capacity:
                self._scorers.pop(next(iter(self._scorers)))
                self.evicted += 1
        self._scorers[session] = sc  # re-insert = most recent
        return sc

    def drop(self, session: str) -> bool:
        """Forget one tenant's penalties entirely (session evict)."""
        return self._scorers.pop(session, None) is not None

    def __len__(self) -> int:
        return len(self._scorers)

    def values(self) -> dict[str, float]:
        """Aggregate reporter surface (per-session detail rides the
        `session`-labeled plane via labeled_values)."""
        return {
            "penaltySessions": float(len(self._scorers)),
            "penaltySessionsEvicted": float(self.evicted),
            "peerPenaltyReports": float(
                sum(s.reports for s in self._scorers.values())
            ),
            "peersBanned": float(
                sum(len(s._banned) for s in self._scorers.values())
            ),
        }

    def labeled_values(self) -> dict[str, dict[str, float]]:
        """{session id: scorer values} for the session-labeled metrics
        plane (core/metrics.py register_labeled_values)."""
        return {sid: s.values() for sid, s in self._scorers.items()}

    def gauge_keys(self) -> set[str]:
        return {"penaltySessions", "peersBanned"}
