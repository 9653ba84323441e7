"""Per-peer penalty scoring: demote and ban misbehaving origins — the
`PeerScorer` of handel_tpu/core/penalty.py.

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
