"""Shared batch-verifier service: many logical nodes, one device plane — a
copy of handel_tpu/parallel/batch_verifier.py.

All co-located nodes funnel their (bitset, signature) candidates into one
queue; a collector task drains it, pads to the device batch size, and
issues a single multi-pairing launch — the device equivalent of a shared
syscall batcher, and what lets one card serve the candidates of thousands
of logical nodes.

Requests are tagged with the aggregation SESSION they belong to. A
deficit-round-robin `TenantQueue` (service/fairness.py) keeps one FIFO per
session, so concurrent sessions share the device plane without a hot
session starving the rest, and one coalesced launch fills its lanes from
whichever sessions have pending work. Devices exposing `dispatch_multi`
(per-lane messages — service/driver.py `HostDevice`) take the whole
mixed-session batch as ONE launch; single-message devices (the port's
`BN254Device`) get one launch per distinct message. Dedup verdicts are
keyed per session: the same aggregate content seen by two different
sessions is two different facts, never cross-deduped.

The service accepts either one device engine or a `DevicePlane` of K
(parallel/plane.py). Each plane lane owns its dispatch slot, in-flight
window, and circuit breaker; the collector reserves the least-loaded free
lane BEFORE draining the tenant queue, then per-lane dispatcher/fetcher
tasks run the two pipeline stages concurrently. A bare engine is wrapped
in a plane of one, so the single-card path is the same code with K=1.

Threads: a lane's `dispatch` and `fetch` run in the loop's default
executor, so an engine is driven from worker threads while the loop goes
on; with `max_inflight` > 1 the dispatch of launch n+1 can run while the
fetch of launch n waits. models/bn254_torch.py says how its engine stays
safe under that.

Tracing: with a `FlightRecorder` (core/trace.py) the service records each
launch's host pack (`dispatch_pack`) and device wall (`device_verify`) on
its own trace thread (`SERVICE_TID`), each lane's launch lifecycle
(`launch_queued`, `launch_staged`, `launch_on_device`, `launch_fetched`) on
the lane's thread, and breaker, failover and lifecycle instants. Untraced,
each hook is one `is None` test. `launch_on_device` runs from the
dispatch's return to the verdicts, as in the reference, unless the engine
can say when the launch ran: a card engine's `device_span(handle)` gives
its first and last op on the verify stream (models/bn254_torch.py), which
is what an eager, host-bound dispatch needs, since its ops run while it
issues them.
"""


from __future__ import annotations

import asyncio
from functools import partial
from typing import Callable, Sequence

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger
from handel_tpu_torch.core.store import VerifiedAggCache
from handel_tpu_torch.core.trace import SERVICE_TID, trace_now
from handel_tpu_torch.parallel.mesh_plane import MODE_LATENCY, ModePolicy
from handel_tpu_torch.parallel.plane import BREAKER_CODE, DeviceLane, DevicePlane
from handel_tpu_torch.service.fairness import TenantQueue
from handel_tpu_torch.utils.breaker import CircuitBreaker

__all__ = ["BatchVerifierService", "CircuitBreaker", "DevicePlane"]


# the host fallback contract: (msg, [(global bitset, signature)]) -> verdicts,
# synchronous (it runs in an executor thread). The natural implementation is
# the scheme's own host-side serial batch_verify over the registry pubkeys
# (models/bn254.py BN254Constructor.batch_verify -> ops/bn254_ref math).
FallbackVerifier = Callable[[bytes, Sequence[tuple[BitSet, object]]], list]

# queued-request tuple layout (one flat tuple, future LAST — every consumer
# below indexes it positionally): (session, msg, pubkeys, bitset, sig, fut)
_SESSION, _MSG, _PUBKEYS, _BITSET, _SIG, _FUT = range(6)


class BatchVerifierService:
    """Fuses verify requests from any number of nodes into shared launches.

    Wire into every node's Config.verifier via `.verifier` (or a
    session-tagged wrapper from `session_verifier`). Requests are answered
    with per-candidate verdicts; the collector waits up to `max_delay_ms`
    to fill a batch (latency/occupancy tradeoff knob).

    Per-session dedup: co-located nodes of ONE session all receive (and
    would all verify) the same winning aggregate per level. Requests are
    keyed by exact content — (session, msg, bitset words, signature bytes)
    — against a shared `VerifiedAggCache`, so a candidate ANY co-located
    node of that session already verified resolves instantly, and
    concurrent duplicates coalesce onto the one in-flight copy's lane
    instead of each taking their own. The session id in the key is the
    tenant-isolation boundary: identical bytes in two sessions stay two
    verifications.

    `device` may be a single engine (wrapped in a plane of one; the
    `breaker` argument becomes that lane's breaker) or a `DevicePlane`
    whose lanes already own their breakers. `self.device`/`self.breaker`
    always alias lane 0 — the single-chip monitoring/back-compat surface.
    """

    def __init__(
        self,
        device,
        max_delay_ms: float = 2.0,
        max_inflight: int = 2,
        dedup_cache: VerifiedAggCache | None = None,
        fallback: FallbackVerifier | None = None,
        breaker: CircuitBreaker | None = None,
        retry_limit: int = 2,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 1.0,
        logger: Logger = DEFAULT_LOGGER,
        recorder=None,
        quantum: int = 8,
        max_pending_per_session: int = 4096,
        queue_capacity: int = 0,
        mode_policy: ModePolicy | None = None,
    ):
        if isinstance(device, DevicePlane):
            self.plane = device
        else:
            self.plane = DevicePlane(
                [device], breakers=[breaker or CircuitBreaker()]
            )
        self.device = self.plane.lanes[0].engine
        self.breaker = self.plane.lanes[0].breaker
        # flight recorder (core/trace.py): dispatch-pack (host prep) and
        # device-verify (launch wall) spans + breaker/failover instants,
        # recorded on the service's own trace lane (SERVICE_TID)
        self.rec = recorder
        if recorder is not None:
            recorder.name_thread(SERVICE_TID, "batch-verifier")
            # each card is a named trace thread carrying its launch
            # lifecycle (queued/staged/on-device/fetched spans below)
            for lane in self.plane.lanes:
                recorder.name_thread(
                    lane.trace_tid, f"device-lane-{lane.index}"
                )
        for lane in self.plane.lanes:
            self._hook_breaker(lane)
        self.max_delay = max_delay_ms / 1000.0
        self.max_inflight = max(1, max_inflight)
        # -- resilience plane: per-lane breakers + host failover ------------
        # transient device errors retry with capped exponential backoff;
        # persistent ones open THAT lane's breaker so the scheduler routes
        # around the chip. Only when every lane's breaker is open do batches
        # go to `fallback` (host reference verifier) — a dead accelerator
        # degrades throughput instead of stalling every node.
        self.fallback = fallback
        self.retry_limit = max(0, retry_limit)
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.log = logger
        self.device_retries = 0
        self.failover_batches = 0
        self.failover_candidates = 0
        # tenant-tagged pending queue: per-session FIFOs drained
        # deficit-round-robin so one hot session cannot starve the rest.
        # The per-tenant bound is the service-side admission control — a
        # refused push fails that request's future immediately and the
        # session's own pipeline absorbs it under its retry budget.
        # `queue_capacity` > 0 arms SLO load shedding (service/fairness.py
        # SloTier): global depth past a tier's shed_at fraction refuses
        # that tier's new work at the door, bronze before gold
        self.queue = TenantQueue(
            quantum=quantum, max_pending=max_pending_per_session,
            capacity=queue_capacity,
        )
        self._kick = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._lane_tasks: list[asyncio.Task] = []
        self._free: asyncio.Event | None = None
        # lifecycle plane (the reference's lifecycle/): the validator-set
        # epoch joins every dedup key, so a verdict computed against epoch E's
        # registry is never replayed after a rotation; `_gate` pauses the
        # collector's intake during quiesce_and (set = running), and
        # `_collector_busy` marks the collector mid-batch so the quiesce
        # knows when it has parked at the gate.
        self.epoch = 0
        self._gate: asyncio.Event | None = None
        self._collector_busy = False
        self.quiesce_ct = 0
        self.last_quiesce_stall_ms = 0.0
        # the batch held by the collector between queue.take() and lane
        # hand-off — outside the queue and every lane structure — so stop()
        # can fail its waiters too. Batches held by lane
        # stages are tracked on the lanes (dispatching/fetching); the
        # `_collecting`/`_fetching` properties below present the union.
        self._collector_held: list | None = None
        # verified-aggregate dedup (shared across every node on this
        # service, keyed per session)
        self.cache = dedup_cache or VerifiedAggCache(capacity=8192)
        self._inflight: dict[tuple, asyncio.Future] = {}
        # counters for the monitor plane
        self.launches = 0
        self.candidates = 0
        # launch fill accounting (satellite fix): occupied lanes / lane
        # capacity recorded PER DISPATCHED LAUNCH, so coalescing wins are
        # measurable against the pre-service baseline. `launches`/
        # `candidates` above count at fetch (verdict) time and exclude
        # failover batches; these count at dispatch time.
        self.fill_sum = 0.0
        self.fill_launches = 0
        self.last_fill = 0.0
        self.coalesced_launches = 0  # launches mixing >1 distinct message
        # dual-mode scheduling (parallel/mesh_plane.py): consulted the
        # moment the plane carries a mesh lane. Counters split the launch
        # groups by the mode that actually dispatched them; a latency-
        # eligible group that found the mesh busy (or broken) falls back
        # to the throughput path and counts a mesh fallback.
        self.mode_policy = mode_policy or ModePolicy()
        self.latency_launches = 0
        self.throughput_launches = 0
        self.mesh_fallbacks = 0
        # per-tenant counters (service plane labels)
        self.tenant_candidates: dict[str, int] = {}
        self.tenant_dedup_hits: dict[str, int] = {}

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._free = asyncio.Event()
        self._gate = asyncio.Event()
        self._gate.set()
        self._lane_tasks = []
        for lane in self.plane.lanes:
            # hand-off cell (collector -> lane dispatcher; capacity 1: a
            # lane is reserved before the collector drains the queue, so it
            # never carries more than one undelivered group) and the
            # bounded dispatch->fetch window: dispatch of launch N+1
            # proceeds while N's verdicts are still in flight, so a
            # launch's host half overlaps the device time of the one
            # before it instead of serializing with it. maxsize bounds
            # device-side queue depth PER LANE.
            self._wire_lane(loop, lane)
        self._task = loop.create_task(self._collector())

    def _wire_lane(self, loop, lane: DeviceLane) -> None:
        """Bind one lane's asyncio plumbing and spawn its task pair (used
        by start() for the initial plane and attach_lane() for growth)."""
        lane.q = asyncio.Queue(maxsize=1)
        lane.fetch_q = asyncio.Queue(maxsize=self.max_inflight)
        lane.tasks = (
            loop.create_task(self._lane_dispatcher(lane)),
            loop.create_task(self._lane_fetcher(lane)),
        )
        self._lane_tasks.extend(lane.tasks)

    def stop(self) -> None:
        """Cancel every pipeline stage and FAIL any unanswered waiters —
        dropping them would leave callers awaiting forever. That includes
        the batch each stage holds OUTSIDE the queues while it works
        (collector hand-off, dispatch or fetch in flight on any lane):
        cancelling the stage strands those futures unless they are failed
        here. Resetting _task lets a later verify() restart the service."""
        if self._task:
            self._task.cancel()
            self._task = None
        for t in self._lane_tasks:
            t.cancel()
        self._lane_tasks = []
        err = RuntimeError("batch verifier stopped")

        def fail(items) -> None:
            for it in items or ():
                if not it[_FUT].done():
                    it[_FUT].set_exception(err)

        for lane in self.plane.lanes:
            if lane.fetch_q is not None:
                while True:
                    try:
                        items = lane.fetch_q.get_nowait()[1]
                    except asyncio.QueueEmpty:
                        break
                    fail(items)
                lane.fetch_q = None
            if lane.q is not None:
                while True:
                    try:
                        items = lane.q.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    fail(items)
                lane.q = None
            fail(lane.dispatching)
            fail(lane.fetching)
            lane.dispatching = lane.fetching = None
            lane.tasks = ()
        fail(self._collector_held)
        self._collector_held = None
        fail(self.queue.drain())
        # coalesced duplicates chained onto a failed primary are resolved by
        # their done-callbacks when the loop next runs; nothing to do here
        self._inflight.clear()

    # -- back-compat observation surface (telemetry + stop()-era tests) ----

    @property
    def _collecting(self) -> list | None:
        """The batch (if any) currently between the tenant queue and a
        lane's fetch window — collector hand-off or dispatch in flight."""
        if self._collector_held is not None:
            return self._collector_held
        for lane in self.plane.lanes:
            if lane.dispatching is not None:
                return lane.dispatching
        return None

    @property
    def _fetching(self) -> list | None:
        for lane in self.plane.lanes:
            if lane.fetching is not None:
                return lane.fetching
        return None

    @property
    def _fetch_q(self) -> asyncio.Queue | None:
        """Lane 0's in-flight window (single-chip back-compat; telemetry
        prefers `inflight_launches()` which sums the fleet)."""
        return self.plane.lanes[0].fetch_q

    def inflight_launches(self) -> int:
        """Dispatched launches whose verdicts haven't landed, fleet-wide."""
        return self.plane.inflight_launches()

    async def verify(
        self, msg, pubkeys, requests, session: str = "",
        dedup_scope: str | None = None,
    ) -> list[bool]:
        """AsyncVerifier-compatible entry (core/processing.py). `session`
        tags the requests with their aggregation instance: fairness,
        admission bounds and teardown are all keyed by it. Dedup verdicts
        are keyed by `dedup_scope` when given, else by `session`: the
        reference's swarm runtime runs one session per COMMITTEE MEMBER,
        and every member of one committee sees the same winning aggregates —
        a shared scope lets the whole committee cross-dedup identical
        content while fairness still isolates per-member queues. Distinct
        committees must pass distinct scopes (the tenant-isolation rule
        from the class docstring, one level up)."""
        if self._task is None:
            self.start()
        loop = asyncio.get_running_loop()
        scope = session if dedup_scope is None else dedup_scope
        futs = []
        for bs, sig in requests:
            # content digest, not raw words: one 65k-committee bitset is
            # 4 KB of words and this cache holds thousands of entries. The
            # epoch rides the key so a registry rotation invalidates every
            # pre-rotation verdict without a cache sweep (scope stays the
            # key head: drop_scope/forget_session match on it).
            key = (
                scope, self.epoch, msg,
                VerifiedAggCache.content_digest(bs, sig),
            )
            cached = self.cache.get(key)
            if cached is not None:
                # some co-located node of this session already verified
                # this exact aggregate
                self.tenant_dedup_hits[session] = (
                    self.tenant_dedup_hits.get(session, 0) + 1
                )
                fut = loop.create_future()
                fut.set_result(cached)
                futs.append(fut)
                continue
            primary = self._inflight.get(key)
            if primary is not None and not primary.done():
                # identical candidate already in flight: ride its lane. A
                # dedup hit for lane accounting — undo the get()'s miss count
                self.cache.misses -= 1
                self.cache.hits += 1
                self.tenant_dedup_hits[session] = (
                    self.tenant_dedup_hits.get(session, 0) + 1
                )
                fut = loop.create_future()
                primary.add_done_callback(partial(self._chain, fut))
                futs.append(fut)
                continue
            fut = loop.create_future()
            if not self.queue.push(
                session, (session, msg, pubkeys, bs, sig, fut)
            ):
                # per-tenant admission bound: the hot session absorbs its
                # own refusal through the pipeline's requeue/retry budget
                fut.set_exception(
                    RuntimeError(
                        f"batch verifier: session {session!r} queue full"
                    )
                )
                futs.append(fut)
                continue
            self.tenant_candidates[session] = (
                self.tenant_candidates.get(session, 0) + 1
            )
            self._inflight[key] = fut
            fut.add_done_callback(partial(self._uninflight, key))
            futs.append(fut)
        self._kick.set()
        return list(await asyncio.gather(*futs))

    def session_verifier(self, session: str, dedup_scope: str | None = None):
        """A Config.verifier-shaped wrapper tagging every request with
        `session` (the per-node pipeline's verifier contract has no session
        argument — the tag rides the closure). `dedup_scope` overrides the
        verdict-cache scope (see `verify`); the swarm passes its committee
        id so co-resident members share verdicts."""

        async def verify(msg, pubkeys, requests):
            return await self.verify(
                msg, pubkeys, requests, session=session,
                dedup_scope=dedup_scope,
            )

        return verify

    def forget_session(self, session: str) -> int:
        """Drop every trace of one tenant (SessionManager evict): queued
        requests fail immediately, dedup verdicts and counters vanish.
        Returns the number of queued requests dropped."""
        dropped = self.queue.drop_tenant(session)
        err = RuntimeError(f"batch verifier: session {session!r} evicted")
        for it in dropped:
            if not it[_FUT].done():
                it[_FUT].set_exception(err)
        for key in [k for k in self._inflight if k[0] == session]:
            self._inflight.pop(key, None)
        self.cache.drop_scope(session)
        self.tenant_candidates.pop(session, None)
        self.tenant_dedup_hits.pop(session, None)
        return len(dropped)

    # -- lifecycle plane (the reference's lifecycle/) ----------------------

    def _plane_idle(self) -> bool:
        """No launch anywhere between collector hand-off and verdict."""
        if self._collector_busy or self._collector_held is not None:
            return False
        return not any(
            l.dispatching is not None or l.fetching is not None
            or (l.fetch_q is not None and l.fetch_q.qsize())
            for l in self.plane.lanes
        )

    async def quiesce_and(self, fn: Callable[[], None]) -> float:
        """Pause intake, wait until every in-flight launch has resolved,
        run `fn` (e.g. flip every engine's staged registry bank), resume.
        Queued work is NOT dropped — it waits in the tenant queue and
        dispatches against the post-`fn` plane; nothing in flight is
        interrupted, so zero futures drop. Returns the stall in seconds
        (gate-closed wall — the launch gap an epoch swap costs)."""
        if self._task is None:
            fn()
            return 0.0
        t0 = trace_now()
        self._gate.clear()
        try:
            while not self._plane_idle():
                await asyncio.sleep(0.001)
            fn()
        finally:
            self._gate.set()
            self._kick.set()
        stall = trace_now() - t0
        self.quiesce_ct += 1
        self.last_quiesce_stall_ms = stall * 1e3
        if self.rec is not None:
            self.rec.span(
                "plane_quiesce", t0, t0 + stall, tid=SERVICE_TID,
                cat="lifecycle", args={"stall_ms": round(stall * 1e3, 3)},
            )
        return stall

    def _hook_breaker(self, lane: DeviceLane) -> None:
        """Make this lane's breaker transitions observable: each state
        edge emits a trace instant on the lane's own trace thread. The
        monotonic count itself rides the breaker (`transitions`, summed
        into values() breakerTransitionsCt)."""
        def on_transition(prev: str, new: str,
                          _lane: DeviceLane = lane) -> None:
            if self.rec is not None:
                self.rec.instant(
                    "breaker_transition", tid=_lane.trace_tid,
                    cat="resilience",
                    args={"lane": _lane.index, "from": prev, "to": new},
                )

        lane.breaker.on_transition = on_transition

    def attach_lane(self, engine, breaker: CircuitBreaker | None = None,
                    mesh: bool = False) -> DeviceLane:
        """Grow the verify plane by one lane, live (LaneAutoscaler scale-up
        or breaker-open replacement). When the service is running, the
        lane's dispatcher/fetcher pair spawns immediately and the scheduler
        can route to it from the next pick. `mesh=True` attaches a
        latency-plane mesh lane (parallel/mesh_plane.py enable_latency_
        plane): only latency-mode groups are routed to it."""
        lane = self.plane.add_lane(engine, breaker, mesh=mesh)
        self._hook_breaker(lane)
        if self.rec is not None:
            kind = "device-mesh" if mesh else "device-lane"
            self.rec.name_thread(lane.trace_tid, f"{kind}-{lane.index}")
            self.rec.instant(
                "lane_attached", tid=SERVICE_TID, cat="lifecycle",
                args={
                    "lane": lane.index, "lanes": len(self.plane),
                    "mesh": mesh,
                },
            )
        if self._task is not None:
            self._wire_lane(asyncio.get_running_loop(), lane)
            self._free.set()  # a new free lane exists: wake the collector
        return lane

    async def drain_lane(
        self, lane: DeviceLane, timeout_s: float = 30.0,
    ) -> bool:
        """Gracefully retire one lane: stop routing to it, let its
        in-flight launches resolve, then cancel its task pair and drop it
        from the plane. Returns False when the drain timed out (the lane's
        remaining work was failed over and the lane removed anyway — a
        wedged chip must not be immortal)."""
        lane.draining = True
        deadline = trace_now() + timeout_s
        while (
            lane.dispatching is not None or lane.fetching is not None
            or (lane.fetch_q is not None and lane.fetch_q.qsize())
        ):
            if trace_now() >= deadline:
                break
            await asyncio.sleep(0.001)
        clean = (
            lane.dispatching is None and lane.fetching is None
            and (lane.fetch_q is None or not lane.fetch_q.qsize())
        )
        for t in lane.tasks:
            t.cancel()
            try:
                self._lane_tasks.remove(t)
            except ValueError:
                pass
        # anything the timeout stranded goes to failover/failure so no
        # caller awaits forever (the stop() contract, per lane)
        leftovers: list = []
        if lane.fetch_q is not None:
            while True:
                try:
                    leftovers.extend(lane.fetch_q.get_nowait()[1])
                except asyncio.QueueEmpty:
                    break
        if lane.dispatching is not None:
            leftovers.extend(lane.dispatching)
        if lane.fetching is not None:
            leftovers.extend(lane.fetching)
        lane.dispatching = lane.fetching = None
        lane.q = lane.fetch_q = None
        lane.tasks = ()
        self.plane.remove_lane(lane)
        if leftovers:
            await self._failover(leftovers)
        if self.rec is not None:
            self.rec.instant(
                "lane_drained", tid=SERVICE_TID, cat="lifecycle",
                args={
                    "lane": lane.index, "clean": clean,
                    "lanes": len(self.plane),
                },
            )
        if self._free is not None:
            self._free.set()  # re-evaluate scheduling after the shrink
        return clean

    @staticmethod
    def _chain(fut: asyncio.Future, primary: asyncio.Future) -> None:
        """Copy a resolved primary's outcome onto a coalesced duplicate."""
        if fut.done():
            return
        if primary.cancelled():
            fut.cancel()
        elif primary.exception() is not None:
            fut.set_exception(primary.exception())
        else:
            fut.set_result(primary.result())

    def _uninflight(self, key: tuple, fut: asyncio.Future) -> None:
        """Primary resolved: drop the in-flight marker and remember the
        verdict so later copies of this aggregate never reach the device."""
        if self._inflight.get(key) is fut:
            del self._inflight[key]
        if not fut.cancelled() and fut.exception() is None:
            self.cache.put(key, bool(fut.result()))

    @property
    def verifier(self):
        return self.verify

    def queue_depth(self) -> int:
        """Total queued candidates across every tenant (telemetry plane)."""
        return len(self.queue)

    def _plan_launches(self, batch: list) -> list[list]:
        """Split one fairly-drained batch into launch groups. A device with
        `dispatch_multi` (per-lane messages) takes the WHOLE mixed-session
        batch as one coalesced launch; a single-message device gets one
        launch per distinct message (the pre-service behavior)."""
        if hasattr(self.device, "dispatch_multi"):
            return [batch]
        by_msg: dict[bytes, list] = {}
        for it in batch:
            by_msg.setdefault(it[_MSG], []).append(it)
        return list(by_msg.values())

    def _launch_call(self, lane: DeviceLane, items: list):
        """The device call for one launch group (runs in an executor)."""
        if hasattr(lane.engine, "dispatch_multi"):
            return partial(
                lane.engine.dispatch_multi,
                [(it[_MSG], it[_PUBKEYS], it[_BITSET], it[_SIG])
                 for it in items],
            )
        return partial(
            lane.engine.dispatch,
            items[0][_MSG],
            [(it[_BITSET], it[_SIG]) for it in items],
        )

    def _group_tier(self, items):
        """The best SLO tier riding one launch group — highest DRR weight,
        ties broken by the tighter p99 target. A mixed gold/bronze group
        routes by its gold passenger: the urgent work defines the group's
        latency entitlement."""
        tiers = {self.queue.tier_of(it[_SESSION]) for it in items}
        return max(tiers, key=lambda t: (t.weight, -t.p99_target_s))

    def _route_mesh(self, items) -> DeviceLane | None:
        """Dual-mode scheduling (parallel/mesh_plane.py): pick this launch
        group's mode from its size, the backlog left in the tenant queue,
        and its best SLO tier; return a free mesh lane for latency-mode
        groups. None = throughput path — either the policy said so, the
        plane has no mesh lane, or the mesh is busy/broken (counted as a
        mesh fallback; breaker-open mesh lanes degrade latency mode to
        throughput, never to failover)."""
        mesh = self.plane.mesh_lanes()
        if not mesh:
            return None
        mesh_batch = min(l.engine.batch_size for l in mesh)
        mode = self.mode_policy.pick_mode(
            len(items), len(self.queue), self._group_tier(items), mesh_batch
        )
        if mode != MODE_LATENCY:
            self.throughput_launches += 1
            return None
        lane = self.plane.pick_mesh()
        if lane is None:
            self.mesh_fallbacks += 1
            self.throughput_launches += 1
            return None
        self.latency_launches += 1
        return lane

    async def _acquire_lane(self) -> DeviceLane | None:
        """Reserve the least-loaded free THROUGHPUT lane, waiting for one
        to free up when every admissible lane is occupied. None means every
        throughput lane's breaker is open — the caller routes the group to
        failover (the single-chip breaker-open behavior, fleet-wide; a
        healthy mesh lane does not keep bulk groups alive, they don't fit
        its launch shape)."""
        while True:
            lane = self.plane.pick()
            if lane is not None or not self.plane.throughput_pool():
                return lane
            self._free.clear()
            await self._free.wait()

    async def _collector(self) -> None:
        while True:
            self._collector_busy = False
            # quiesce gate (quiesce_and): cleared while a registry
            # flip needs the plane idle; intake parks here, the tenant
            # queue keeps absorbing (and admission-bounding) arrivals
            await self._gate.wait()
            if not len(self.queue):
                self._kick.clear()
                await self._kick.wait()
                continue  # re-check the gate before touching the queue
            self._collector_busy = True
            # brief accumulation window so co-located nodes (and sessions)
            # share the launch
            if len(self.queue) < self.device.batch_size:
                await asyncio.sleep(self.max_delay)
            # reserve a dispatch slot BEFORE draining the tenant queue:
            # while every lane is occupied, pending work stays in the
            # tenant queue where fairness, admission bounds and
            # forget_session() can still reach it
            lane = await self._acquire_lane()
            batch = self.queue.take(self.device.batch_size)
            if not batch:
                continue
            # from here until every group is handed to a lane the batch
            # lives in neither the queue nor any lane structure: track it
            # on self so stop() can fail these futures if this task is
            # cancelled mid-hand-off
            self._collector_held = batch
            for i, items in enumerate(self._plan_launches(batch)):
                # dual-mode routing: a latency-mode group takes the mesh
                # lane (no wait — _route_mesh only returns a FREE one);
                # everything else rides the reserved throughput lane
                target = self._route_mesh(items)
                if target is None:
                    if i:
                        lane = await self._acquire_lane()
                    target = lane
                if target is None:
                    # every breaker open: host failover (or fail the
                    # futures when no fallback exists)
                    await self._failover(items)
                    continue
                # mark BEFORE the put: `dispatching` is both the lane's
                # occupied flag and stop()'s handle on the group (the queue
                # item is the same list object, so a drain double-fail is a
                # no-op). No await between pick and put -> put_nowait is
                # safe on the capacity-1 cell.
                target.dispatching = items
                if self.rec is not None and self.rec.enabled:
                    # launch_queued span start (the dispatcher reads it when
                    # it takes the group off the capacity-1 cell)
                    target.queued_ts = trace_now()
                target.q.put_nowait(items)
            self._collector_held = None

    def _lane_span_args(self, lane: DeviceLane, items: list) -> dict:
        """Launch-lifecycle span args: lane, group size, and the sessions
        whose candidates ride this launch (computed only while tracing —
        the set build never runs on the untraced hot path)."""
        args = {
            "lane": lane.index, "n": len(items),
            "mode": "mesh" if lane.mesh else "lane",
        }
        sessions = sorted({it[_SESSION] for it in items if it[_SESSION]})
        if sessions:
            args["sessions"] = ",".join(sessions)
        return args

    async def _lane_dispatcher(self, lane: DeviceLane) -> None:
        """Per-lane first pipeline stage: dispatch groups handed to this
        lane (host prep + async enqueue), then push the handle into the
        lane's in-flight window. Blocking on a full window keeps the lane
        marked occupied — that is the per-chip backpressure."""
        while True:
            items = await lane.q.get()
            handle = None
            tracing = self.rec is not None and self.rec.enabled
            t_deq = trace_now() if tracing else 0.0
            if tracing and lane.queued_ts:
                # time the group sat in the hand-off cell waiting for this
                # lane — the first stage of its lifecycle timeline
                self.rec.span(
                    "launch_queued",
                    lane.queued_ts,
                    t_deq,
                    tid=lane.trace_tid,
                    cat="device",
                    args=self._lane_span_args(lane, items),
                )
            if lane.breaker.allow():
                t0 = trace_now()
                handle = await self._dispatch_with_retries(
                    lane, self._launch_call(lane, items)
                )
                if tracing:
                    t_disp = trace_now()
                    # the host half of a launch: request packing + the
                    # async enqueue (the engine's host pack time lives in here)
                    self.rec.span(
                        "dispatch_pack",
                        t0,
                        t_disp,
                        tid=SERVICE_TID,
                        cat="verifier",
                        args={
                            "n": len(items),
                            "ok": handle is not None,
                            "device": lane.index,
                        },
                    )
                    # same interval on the lane's own timeline: host staging
                    self.rec.span(
                        "launch_staged",
                        t0,
                        t_disp,
                        tid=lane.trace_tid,
                        cat="device",
                        args=self._lane_span_args(lane, items),
                    )
            if handle is None:
                # this lane's breaker opened (or retries exhausted): the
                # group fails over; FUTURE groups go to other lanes
                await self._failover(items)
            else:
                # launch fill: occupied lanes over THIS lane's capacity
                # (a mesh lane's small-batch engine fills differently from
                # the throughput lanes), recorded per dispatched launch on
                # both the service aggregate and the device-labeled row
                fill = len(items) / lane.engine.batch_size
                self.last_fill = fill
                self.fill_sum += fill
                self.fill_launches += 1
                lane.last_fill = fill
                lane.fill_sum += fill
                lane.launches += 1
                lane.candidates += len(items)
                if len({it[_MSG] for it in items}) > 1:
                    self.coalesced_launches += 1
                # dispatch-completion stamp rides to the fetcher: the
                # launch_on_device span starts where staging ended
                await lane.fetch_q.put((handle, items, trace_now()))
            lane.dispatching = None
            self._free.set()

    async def _dispatch_with_retries(self, lane: DeviceLane, call):
        """Try the lane's device up to 1 + retry_limit times; None = gave
        up (each failure feeds THAT lane's breaker)."""
        loop = asyncio.get_running_loop()
        for attempt in range(1 + self.retry_limit):
            try:
                return await loop.run_in_executor(None, call)
            except asyncio.CancelledError:
                raise  # stop() fails the futures via lane.dispatching
            except Exception as e:
                lane.breaker.record_failure()
                if self.rec is not None:
                    self.rec.instant(
                        "device_error",
                        tid=SERVICE_TID,
                        cat="verifier",
                        args={
                            "stage": "dispatch",
                            "device": lane.index,
                            "breaker": lane.breaker.state,
                        },
                    )
                self.log.warn(
                    "verifier_device_error",
                    f"dispatch attempt {attempt + 1} "
                    f"(device {lane.index}): {e}",
                )
                if not lane.breaker.allow() or attempt >= self.retry_limit:
                    return None
                self.device_retries += 1
                lane.retries += 1
                await asyncio.sleep(
                    min(self.backoff_base_s * 2**attempt, self.backoff_cap_s)
                )
        return None

    async def _failover(self, items) -> None:
        """Resolve a launch group through the host reference verifier; with
        no fallback configured, fail the futures (BatchProcessing requeues
        the candidates under its retry budget — the pre-breaker behavior).
        A coalesced group can span messages: the (msg, reqs) fallback
        contract is honored by resolving one message group at a time."""
        if self.fallback is None:
            err = RuntimeError("batch verifier: device unavailable")
            for it in items:
                if not it[_FUT].done():
                    it[_FUT].set_exception(err)
            return
        if self.rec is not None:
            self.rec.instant(
                "verifier_failover",
                tid=SERVICE_TID,
                cat="verifier",
                args={
                    "n": len(items),
                    "devices_available": len(self.plane.allowed()),
                },
            )
        by_msg: dict[bytes, list] = {}
        for it in items:
            by_msg.setdefault(it[_MSG], []).append(it)
        loop = asyncio.get_running_loop()
        for msg, group in by_msg.items():
            reqs = [(it[_BITSET], it[_SIG]) for it in group]
            try:
                verdicts = await loop.run_in_executor(
                    None, partial(self.fallback, msg, reqs)
                )
            except asyncio.CancelledError:
                raise
            except Exception as e:
                for it in group:
                    if not it[_FUT].done():
                        it[_FUT].set_exception(
                            RuntimeError(f"batch verifier: {e}")
                        )
                continue
            self.failover_batches += 1
            self.failover_candidates += len(group)
            for it, ok in zip(group, verdicts):
                if not it[_FUT].done():
                    it[_FUT].set_result(bool(ok))

    async def _lane_fetcher(self, lane: DeviceLane) -> None:
        """Per-lane second pipeline stage: pull verdicts for this lane's
        dispatched launches, in dispatch order, and resolve the waiters."""
        loop = asyncio.get_running_loop()
        while True:
            handle, items, t_disp = await lane.fetch_q.get()
            # outside the window until resolved: visible to stop() (see
            # _collector's mirror note)
            lane.fetching = items
            t0 = trace_now()
            try:
                verdicts = await loop.run_in_executor(
                    None, partial(lane.engine.fetch, handle)
                )
            except asyncio.CancelledError:
                raise  # stop() fails the futures via lane.fetching
            except Exception as e:
                # a fetch-side device death (verdict transfer failed) takes
                # the same breaker + host-failover path as dispatch errors
                lane.breaker.record_failure()
                self.log.warn(
                    "verifier_device_error",
                    f"fetch (device {lane.index}): {e}",
                )
                await self._failover(items)
                lane.fetching = None
                continue
            if self.rec is not None and self.rec.enabled:
                t_end = trace_now()
                # device wall per launch (verdict-arrival latency), the
                # counterpart of dispatch_pack's host half
                self.rec.span(
                    "device_verify",
                    t0,
                    t_end,
                    tid=SERVICE_TID,
                    cat="verifier",
                    args={"n": len(items), "device": lane.index},
                )
                largs = self._lane_span_args(lane, items)
                # on a card engine: the launch's own interval on its stream
                span = getattr(lane.engine, "device_span", None)
                on_device = span(handle) if span is not None else None
                t_on, t_off = on_device or (t_disp, t_end)
                # lane-timeline remainder of the lifecycle: in flight on
                # the chip since dispatch, and the verdict transfer window.
                # Mesh launches carry their own span name so the critical-
                # path analyzer (sim/trace_cli.py) attributes whole-mesh
                # walls distinctly from per-chip lane walls.
                self.rec.span(
                    "launch_on_mesh" if lane.mesh else "launch_on_device",
                    t_on,
                    t_off,
                    tid=lane.trace_tid,
                    cat="device",
                    args=largs,
                )
                self.rec.span(
                    "launch_fetched",
                    t0,
                    t_end,
                    tid=lane.trace_tid,
                    cat="device",
                    args=largs,
                )
            lane.breaker.record_success()
            lane.fetched += 1
            self.launches += 1
            self.candidates += len(items)
            for it, ok in zip(items, verdicts):
                if not it[_FUT].done():
                    it[_FUT].set_result(ok)
            lane.fetching = None

    def session_values(self) -> dict[str, dict[str, float]]:
        """Per-tenant reporter surface for the `session`-labeled metrics
        plane (core/metrics.py register_labeled_values): every session that
        currently has queued work or has ever enqueued through this
        service."""
        depths = self.queue.depths()
        out: dict[str, dict[str, float]] = {}
        for sid in set(depths) | set(self.tenant_candidates):
            out[sid] = {
                "queueDepth": float(depths.get(sid, 0)),
                "candidates": float(self.tenant_candidates.get(sid, 0)),
                "dedupHits": float(self.tenant_dedup_hits.get(sid, 0)),
            }
        return out

    def session_gauge_keys(self) -> set[str]:
        return {"queueDepth"}

    def values(self) -> dict[str, float]:
        # host pack/dispatch accounting SUMMED over the fleet's engines
        # (it used to read the counters off device 0 only — wrong the
        # moment a second chip dispatched anything)
        hc = self.plane.host_cost()
        pack_ms, pack_n = hc["pack_ms"], hc["pack_launches"]
        disp_ms, disp_n = hc["dispatch_ms"], hc["dispatch_launches"]
        return {
            "verifierLaunches": float(self.launches),
            "verifierCandidates": float(self.candidates),
            "verifierOccupancy": (
                self.candidates / (self.launches * self.device.batch_size)
                if self.launches
                else 0.0
            ),
            # launch fill plane (dispatch-side): per-launch occupied lanes /
            # lane capacity — mean over every dispatched launch plus the
            # most recent launch's fill. The coalescing win metric: a
            # multi-session service should fill lanes the single-session
            # baseline leaves empty.
            "launchFillRatio": (
                self.fill_sum / self.fill_launches if self.fill_launches
                else 0.0
            ),
            "lastLaunchFill": self.last_fill,
            "coalescedLaunches": float(self.coalesced_launches),
            # multi-tenant plane: live tenants with queued work, total
            # queued candidates, per-tenant admission refusals
            "sessionsQueued": float(self.queue.tenants()),
            "verifierQueueDepth": float(len(self.queue)),
            "admissionRefused": float(self.queue.refused),
            # SLO admission plane: tier-shed pushes + the shed fraction
            "admissionShed": float(self.queue.shed),
            "shedRate": self.queue.shed_rate(),
            # host cost of building device inputs (vectorized packer,
            # models/bn254_torch.py); 0 for device stubs without the
            # counter. The cumulative sums are counters; the *PerLaunch
            # averages are declared gauges, a stable per-launch number
            # instead of a monotonically growing one.
            "hostPackMs": pack_ms,
            "hostPackLaunches": pack_n,
            "hostPackMsPerLaunch": pack_ms / pack_n if pack_n else 0.0,
            # the other host half of a launch: staging handoff + async
            # kernel enqueue (host_dispatch_ms, models/bn254_torch.py)
            "hostDispatchMs": disp_ms,
            "hostDispatchLaunches": disp_n,
            "hostDispatchMsPerLaunch": disp_ms / disp_n if disp_n else 0.0,
            # resilience plane: worst lane state + fleet-summed counters
            "breakerState": max(
                BREAKER_CODE[l.breaker.state] for l in self.plane.lanes
            ),
            "breakerOpenCt": float(
                sum(l.breaker.open_count for l in self.plane.lanes)
            ),
            # every observed open/half-open/close edge across the fleet
            # (utils/breaker.py transitions) — the storm-detection signal
            "breakerTransitionsCt": float(
                sum(l.breaker.transitions for l in self.plane.lanes)
            ),
            "deviceRetryCt": float(self.device_retries),
            "failoverBatches": float(self.failover_batches),
            "failoverCandidates": float(self.failover_candidates),
            # dual-mode scheduling plane (parallel/mesh_plane.py): launch
            # groups by dispatched mode + latency-eligible groups that
            # found the mesh busy/broken and fell back to a lane
            "modeLatencyLaunches": float(self.latency_launches),
            "modeThroughputLaunches": float(self.throughput_launches),
            "meshFallbacks": float(self.mesh_fallbacks),
            # lifecycle plane: validator-set epoch + quiesce accounting
            "epoch": float(self.epoch),
            "quiesceCt": float(self.quiesce_ct),
            "lastQuiesceStallMs": self.last_quiesce_stall_ms,
            # fleet plane: lane count, admissible lanes, scheduler audit
            **self.plane.values(),
            # process-wide dedup plane (monitor keys: verifier_dedup*)
            **self.cache.values(),
        }

    def gauge_keys(self) -> set[str]:
        """Explicit gauge declarations (core/metrics.py is_gauge_key)."""
        return {
            "verifierOccupancy",
            "breakerState",
            "launchFillRatio",
            "lastLaunchFill",
            "sessionsQueued",
            "verifierQueueDepth",
            "hostPackMsPerLaunch",
            "hostDispatchMsPerLaunch",
            "devicesTotal",
            "devicesAvailable",
            "meshLanes",
            "meshLanesAvailable",
            "checkMode",
            "bisectionDepthMax",
            "epoch",
            "lastQuiesceStallMs",
            "shedRate",
        } | self.cache.gauge_keys()
