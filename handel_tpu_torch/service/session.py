"""Aggregation-session lifecycle: spawn → running → threshold → expire/evict —
a copy of handel_tpu/service/session.py.

One `Session` is one aggregation instance — a distinct message over its own
committee of logical Handel nodes (an in-process cluster on the shared
event loop, core/test_harness.py). The `SessionManager` multiplexes many of
them onto ONE shared verify plane: every node's Config.verifier is the
shared `BatchVerifierService`'s session-tagged wrapper, so all sessions'
candidates coalesce into the same device launches under the tenant queue's
deficit-round-robin fairness (service/fairness.py), while the per-tenant
state — dedup verdicts, peer penalties, queue bounds — stays keyed by the
session id and is dropped wholesale when the session retires.

Lifecycle:

    spawn   admission-controlled (bounded live-session cap; a finished
            session still held is evicted to make room, else the spawn is
            refused) — nodes are built but not started
    running start() — nodes aggregate; a watcher task awaits completion
    threshold-reached
            every online node emitted a final signature >= threshold; the
            session's nodes stop, its shared-plane state is released, its
            completion latency feeds the manager's p50/p99 surface
    expired the watcher hit the session TTL first — same teardown
    evicted external removal (cap pressure, operator) at any state
"""

from __future__ import annotations

import asyncio
import random
import time
from collections import deque
from typing import Callable, Sequence

from handel_tpu_torch.core.config import Config
from handel_tpu_torch.core.penalty import SessionScorers
from handel_tpu_torch.core.test_harness import FakeScheme, LocalCluster

STATE_SPAWNED = "spawned"
STATE_RUNNING = "running"
STATE_DONE = "threshold-reached"
STATE_EXPIRED = "expired"
STATE_EVICTED = "evicted"

#: numeric form for the metrics plane (handel_service_state{session=...})
STATE_CODE = {
    STATE_SPAWNED: 0.0,
    STATE_RUNNING: 1.0,
    STATE_DONE: 2.0,
    STATE_EXPIRED: 3.0,
    STATE_EVICTED: 4.0,
}


class AdmissionRefused(RuntimeError):
    """spawn() refused: the live-session cap is full of running sessions."""


class Session:
    """One aggregation instance over its own committee (see module doc)."""

    def __init__(
        self,
        sid: str,
        n: int,
        *,
        threshold: int | None = None,
        msg: bytes | None = None,
        scheme=None,
        service=None,
        scorers: SessionScorers | None = None,
        offline: Sequence[int] = (),
        seed: int = 0,
        ttl_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
        config_tweak: Callable[[Config, int], None] | None = None,
        recorder=None,
        epoch: int = 0,
    ):
        self.sid = sid
        self.n = n
        self.clock = clock
        self.ttl_s = ttl_s
        # validator-set epoch this session was spawned under (lifecycle/
        # epoch.py): rides every node Config into dedup keys + trace spans
        self.epoch = epoch
        self.state = STATE_SPAWNED
        self.created_at = clock()
        self.started_at: float | None = None
        self.completed_at: float | None = None
        self.msg = msg if msg is not None else f"session:{sid}".encode()
        self.service = service
        self.finals = None
        self._done_cb: Callable[["Session"], None] | None = None
        self._watch_task: asyncio.Task | None = None

        verifier = (
            service.session_verifier(sid) if service is not None else None
        )

        def factory(i: int) -> Config:
            cfg = Config()
            # per-tenant keying end to end: the session id scopes this
            # node's dedup keys (core/processing.py) and, via the tagged
            # verifier, its share of the fairness queue and the service
            # dedup plane
            cfg.session = sid
            cfg.epoch = epoch
            # shared flight recorder (core/trace.py): every node of every
            # session records into one ring, spans tagged by session above
            cfg.recorder = recorder
            cfg.rand = random.Random(seed * 100003 + i)
            if verifier is not None:
                cfg.verifier = verifier
            if scorers is not None:
                # penalties keyed by session: this committee's trust
                # domain, dropped wholesale at retirement
                cfg.new_scorer = lambda h, _s=scorers: _s.for_session(sid)
            if config_tweak is not None:
                config_tweak(cfg, i)
            return cfg

        self.cluster = LocalCluster(
            n,
            scheme=scheme,
            threshold=threshold,
            offline=offline,
            msg=self.msg,
            config_factory=factory,
            seed=seed,
        )
        self.threshold = self.cluster.threshold

    # -- lifecycle ---------------------------------------------------------

    def start(self, on_done: Callable[["Session"], None] | None = None) -> None:
        """spawned -> running; the watcher resolves the terminal state.
        Must be called from a running asyncio loop."""
        if self.state != STATE_SPAWNED:
            raise RuntimeError(f"session {self.sid} already {self.state}")
        self.state = STATE_RUNNING
        self.started_at = self.clock()
        self._done_cb = on_done
        self.cluster.start()
        self._watch_task = asyncio.get_running_loop().create_task(
            self._watch()
        )

    async def _watch(self) -> None:
        try:
            self.finals = await self.cluster.wait_complete_success(self.ttl_s)
        except asyncio.TimeoutError:
            self._finish(STATE_EXPIRED)
            return
        except asyncio.CancelledError:
            raise
        self._finish(STATE_DONE)

    def _finish(self, state: str) -> None:
        if self.state != STATE_RUNNING:
            return
        self.completed_at = self.clock()
        self.state = state
        self.cluster.stop()
        if self._done_cb is not None:
            self._done_cb(self)

    def stop(self) -> None:
        """Tear the session down without a state transition of its own
        (evict() owns the bookkeeping)."""
        if self._watch_task is not None:
            self._watch_task.cancel()
            self._watch_task = None
        self.cluster.stop()

    # -- introspection ------------------------------------------------------

    @property
    def finished(self) -> bool:
        return self.state in (STATE_DONE, STATE_EXPIRED, STATE_EVICTED)

    def completion_s(self) -> float | None:
        """Wall seconds from start to the terminal transition."""
        if self.completed_at is None or self.started_at is None:
            return None
        return self.completed_at - self.started_at

    def pending_work(self) -> int:
        """Unverified candidates attributable to this session: the nodes'
        own processing queues plus its share of the shared verifier queue."""
        pending = sum(
            len(h.proc.pending()) for h in self.cluster.handels.values()
        )
        if self.service is not None:
            pending += self.service.queue.depth(self.sid)
        return pending

    def nodes_done(self) -> int:
        return sum(
            1
            for h in self.cluster.handels.values()
            if h.best is not None
        )

    def best_cardinality(self) -> int:
        return max(
            (
                h.best.cardinality()
                for h in self.cluster.handels.values()
                if h.best is not None
            ),
            default=0,
        )

    def values(self) -> dict[str, float]:
        """Per-session sample set for the `session`-labeled metrics plane."""
        return {
            "state": STATE_CODE[self.state],
            "pending": float(self.pending_work()),
            "nodesDone": float(self.nodes_done()),
            "nodes": float(self.n),
            "bestCardinality": float(self.best_cardinality()),
            "threshold": float(self.threshold),
            "ageS": self.clock() - self.created_at,
            "completionS": self.completion_s() or 0.0,
        }


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


class SessionManager:
    """Admission-controlled registry of concurrent aggregation sessions.

    `max_sessions` bounds the HELD set — every session whose state (nodes,
    results, per-tenant planes) this process still carries, live or
    finished: a spawn at the cap first evicts a finished session still
    held (freeing its retained results and shared-plane state), and
    refuses with `AdmissionRefused` when every held session is genuinely
    live — backpressure the caller (an ingress layer, the sim driver)
    must surface, not absorb.
    """

    def __init__(
        self,
        service=None,
        scheme=None,
        max_sessions: int = 64,
        session_ttl_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
        scorers: SessionScorers | None = None,
        retired_capacity: int = 4096,
        recorder=None,
    ):
        if max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        self.service = service
        self.recorder = recorder
        self.scheme = scheme or FakeScheme()
        self.max_sessions = max_sessions
        self.session_ttl_s = session_ttl_s
        self.clock = clock
        self.scorers = scorers or SessionScorers()
        self.sessions: dict[str, Session] = {}
        # terminal records of evicted sessions: (sid, state, completion_s)
        self.retired: deque = deque(maxlen=retired_capacity)
        self.completion_s: list[float] = []  # every threshold-reached run
        # lifecycle plane: the epoch new sessions spawn under (bumped by
        # lifecycle/epoch.py EpochManager.commit) + per-tenant SLO tiers
        # and their completion-latency buckets (service/fairness.py TIERS)
        self.epoch = 0
        self.tiers: dict[str, str] = {}
        self.completion_by_tier: dict[str, list[float]] = {}
        self._seq = 0
        # reporter counters
        self.spawned_ct = 0
        self.completed_ct = 0
        self.expired_ct = 0
        self.evicted_ct = 0
        self.refused_ct = 0

    # -- admission + lifecycle ----------------------------------------------

    def live_count(self) -> int:
        return sum(
            1
            for s in self.sessions.values()
            if s.state in (STATE_SPAWNED, STATE_RUNNING)
        )

    def spawn(
        self,
        n: int,
        *,
        sid: str | None = None,
        threshold: int | None = None,
        msg: bytes | None = None,
        offline: Sequence[int] = (),
        seed: int | None = None,
        ttl_s: float | None = None,
        config_tweak=None,
        tier: str | None = None,
    ) -> Session:
        if len(self.sessions) >= self.max_sessions:
            # cap pressure: finished sessions still held are reclaimable
            if not self._evict_one_finished() or (
                len(self.sessions) >= self.max_sessions
            ):
                self.refused_ct += 1
                raise AdmissionRefused(
                    f"{self.live_count()} live / {len(self.sessions)} held "
                    f"sessions at cap {self.max_sessions}"
                )
        self._seq += 1
        sid = sid if sid is not None else f"s{self._seq}"
        if sid in self.sessions:
            raise ValueError(f"session id {sid!r} already exists")
        s = Session(
            sid,
            n,
            threshold=threshold,
            msg=msg,
            scheme=self.scheme,
            service=self.service,
            scorers=self.scorers,
            offline=offline,
            seed=self._seq if seed is None else seed,
            ttl_s=self.session_ttl_s if ttl_s is None else ttl_s,
            clock=self.clock,
            config_tweak=config_tweak,
            recorder=self.recorder,
            epoch=self.epoch,
        )
        if tier is not None:
            # SLO class end to end: recorded here for the per-tier p99
            # surface, pinned on the shared verifier's tenant queue for
            # weighted DRR + load shedding (service/fairness.py)
            self.tiers[sid] = tier
            if self.service is not None:
                self.service.queue.set_tier(sid, tier)
        self.sessions[sid] = s
        self.spawned_ct += 1
        return s

    def start(self, sid: str, on_done=None) -> None:
        """Start a spawned session; `on_done` (optional) observes the
        terminal session AFTER the manager's own accounting — the hook an
        ingress layer (service/federation.py front door) tracks per-arrival
        outcomes with."""
        if on_done is None:
            self.sessions[sid].start(on_done=self._on_session_end)
            return

        def chained(s: Session) -> None:
            self._on_session_end(s)
            on_done(s)

        self.sessions[sid].start(on_done=chained)

    def _on_session_end(self, s: Session) -> None:
        """Watcher callback at threshold-reached/expired: account the
        outcome and release the tenant's shared-plane state (its nodes are
        already stopped — nothing will enqueue under this id again)."""
        if s.state == STATE_DONE:
            self.completed_ct += 1
            done_in = s.completion_s()
            if done_in is not None:
                self.completion_s.append(done_in)
                tier = self.tiers.get(s.sid)
                if tier is not None:
                    self.completion_by_tier.setdefault(tier, []).append(
                        done_in
                    )
        else:
            self.expired_ct += 1
        self._forget_tenant(s.sid)

    def _forget_tenant(self, sid: str) -> None:
        if self.service is not None:
            self.service.forget_session(sid)
        self.scorers.drop(sid)
        # tier mapping is per-live-session state (the per-tier completion
        # buckets above already banked this session's latency)
        self.tiers.pop(sid, None)

    def evict(self, sid: str) -> bool:
        """Remove a session at any state; a live one transitions to
        `evicted` (its nodes stop mid-flight)."""
        s = self.sessions.pop(sid, None)
        if s is None:
            return False
        was_live = s.state in (STATE_SPAWNED, STATE_RUNNING)
        s.stop()
        if was_live:
            s.state = STATE_EVICTED
            s.completed_at = self.clock()
            self.evicted_ct += 1
        self._forget_tenant(sid)
        self.retired.append((sid, s.state, s.completion_s()))
        return True

    def _evict_one_finished(self) -> bool:
        for sid, s in self.sessions.items():
            if s.finished:
                return self.evict(sid)
        return False

    async def wait_all(self, timeout: float) -> None:
        """Await every currently-running session's watcher (terminal state
        reached: done or expired)."""
        tasks = [
            s._watch_task
            for s in list(self.sessions.values())
            if s._watch_task is not None
        ]
        if tasks:
            await asyncio.wait_for(
                asyncio.gather(*tasks, return_exceptions=True), timeout
            )

    def stop(self) -> None:
        for sid in list(self.sessions):
            self.evict(sid)

    # -- reporting -----------------------------------------------------------

    def tier_quantiles(self) -> dict[str, dict[str, float]]:
        """Per-SLO-tier completion latency against its target
        (service/fairness.py TIERS): the soak harness's "p99 held within
        its tier" acceptance surface."""
        from handel_tpu_torch.service.fairness import DEFAULT_TIER, TIERS

        out: dict[str, dict[str, float]] = {}
        for tier, vals in self.completion_by_tier.items():
            done = sorted(vals)
            target = TIERS.get(tier, DEFAULT_TIER).p99_target_s
            p99 = _quantile(done, 0.99)
            out[tier] = {
                "completed": float(len(done)),
                "p50_s": _quantile(done, 0.50),
                "p99_s": p99,
                "target_s": target,
                "met": 1.0 if p99 <= target else 0.0,
            }
        return out

    def values(self) -> dict[str, float]:
        done = sorted(self.completion_s)
        return {
            "sessionsLive": float(self.live_count()),
            "sessionsHeld": float(len(self.sessions)),
            "sessionsSpawned": float(self.spawned_ct),
            "sessionsCompleted": float(self.completed_ct),
            "sessionsExpired": float(self.expired_ct),
            "sessionsEvicted": float(self.evicted_ct),
            "admissionRefused": float(self.refused_ct),
            "sessionCompletionP50S": _quantile(done, 0.50),
            "sessionCompletionP99S": _quantile(done, 0.99),
            "epoch": float(self.epoch),
        }

    def gauge_keys(self) -> set[str]:
        return {
            "sessionsLive",
            "sessionsHeld",
            "sessionCompletionP50S",
            "sessionCompletionP99S",
            "epoch",
        }

    def labeled_values(self) -> dict[str, dict[str, float]]:
        """{session id: per-session values} for the session-labeled plane
        (core/metrics.py register_labeled_values; `sim watch` renders the
        top-K rows by pending work). Includes the shared verifier's
        per-tenant counters when a service is wired."""
        out = {sid: s.values() for sid, s in self.sessions.items()}
        if self.service is not None:
            for sid, vals in self.service.session_values().items():
                out.setdefault(sid, {}).update(vals)
        return out

    def labeled_gauge_keys(self) -> set[str]:
        keys = {
            "state", "pending", "nodesDone", "nodes", "bestCardinality",
            "threshold", "ageS", "completionS",
        }
        if self.service is not None:
            keys |= self.service.session_gauge_keys()
        return keys
