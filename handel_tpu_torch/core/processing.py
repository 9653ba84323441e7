"""Asynchronous, batch-oriented signature verification pipeline — a copy of
handel_tpu/core/processing.py.

Reference: processing.go:37-368 — `SigEvaluator` (:37-42), the evaluator
processing loop (:144-287) that repeatedly picks the highest-scored pending
signature, verifies it (aggregate-pubkey loop + pairing, :342-368), and
publishes it; and the pre-queue `Filter` (:293-323) deduplicating individual
signatures.

The batched redesign (the one architectural change against the reference):
instead of verifying one best signature at a time, each step scores the todo
queue and hands the top `batch_size` candidates to the scheme's
`batch_verify` — one batched multi-pairing launch on the device. Surviving
candidates are re-scored on the next step, preserving the reference's
prune-after-each-result semantics: we may verify slightly more than the
serial reference, never less.

Verification requests are expressed as *global* registry bitsets (the level
bitset shifted to its range offset), so a device scheme can aggregate public
keys as a masked segment-sum over the dense on-device registry array.
"""

from __future__ import annotations

import asyncio
import heapq
import time
from typing import Awaitable, Callable, Protocol, Sequence

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.crypto import Constructor, PublicKey, Signature
from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger
from handel_tpu_torch.core.partitioner import BinomialPartitioner, IncomingSig
from handel_tpu_torch.core.store import VerifiedAggCache
from handel_tpu_torch.core.trace import LogHistogram, trace_now


class SigEvaluator(Protocol):
    """Scores unverified signatures: 0 = discard, higher = verify sooner
    (processing.go:37-42)."""

    def evaluate(self, sp: IncomingSig) -> int: ...


class Evaluator1:
    """Scores everything 1 — verify every signature (processing.go:46-51)."""

    def evaluate(self, sp: IncomingSig) -> int:
        return 1


class Filter(Protocol):
    """Pre-queue filter (processing.go:293-297)."""

    def accept(self, sp: IncomingSig) -> bool: ...


class IndividualSigFilter:
    """Accept each origin's individual signature only once
    (processing.go:299-323)."""

    def __init__(self):
        self._seen: set[int] = set()

    def accept(self, sp: IncomingSig) -> bool:
        if not sp.individual:
            return True
        if sp.origin in self._seen:
            return False
        self._seen.add(sp.origin)
        return True


class CombineShim:
    """Accumulate-and-flush batcher for aggregate-signature point additions.

    `SignatureStore` merge/patch chains and the partitioner's level
    combination hand whole signature groups to `combine_many` (wired as the
    store's `combiner` hook by core/handel.py); callers that can defer —
    anything resolving several independent merges in one step — `accumulate`
    groups and `flush`, and every group queued at flush time resolves in ONE
    device `combine_batch` launch (models/bn254_torch.py) instead of one
    host point add per contribution.

    Groups below `min_device_points` fold on the host: a device launch beats
    the host add only once enough point adds amortize its round trip. The
    device hook is `constructor.device_combine(groups)`, which returns None
    while the device does not exist yet (the host folds then) and a None
    entry for a group it declines; a launch error raises through the shim.
    """

    def __init__(self, device_combine, min_device_points: int = 4):
        self.device_combine = device_combine
        self.min_device_points = max(2, min_device_points)
        self._queue: list[list] = []
        self._flushed: list = []
        # reporter counters (Handel.values merges them onto the sigs plane)
        self.combine_groups = 0
        self.combine_points = 0
        self.combine_device_groups = 0
        self.combine_host_groups = 0

    @classmethod
    def for_constructor(cls, constructor, **kw) -> "CombineShim | None":
        """A shim when the constructor exposes a device combine hook
        (BN254TorchConstructor.device_combine), else None — host schemes
        keep the store's plain serial path."""
        fn = getattr(constructor, "device_combine", None)
        return cls(fn, **kw) if callable(fn) else None

    @staticmethod
    def _host_fold(sigs):
        sig = sigs[0]
        for s in sigs[1:]:
            sig = s.combine(sig)
        return sig

    def _resolve(self, groups: list[list]) -> list:
        """Resolve many groups: one device launch for those wide enough to
        pay for it, host folds for the rest (and for every group when the
        device declines)."""
        out: list = [None] * len(groups)
        dev_idx = [
            i
            for i, g in enumerate(groups)
            if len(g) >= self.min_device_points
            and all(getattr(s, "point", None) is not None for s in g)
        ]
        if dev_idx and self.device_combine is not None:
            pts = self.device_combine(
                [[s.point for s in groups[i]] for i in dev_idx]
            )
            if pts is not None:
                for i, p in zip(dev_idx, pts):
                    if p is None:
                        # declined (class not warmed) or a legitimate
                        # infinity sum: both redo on the host, which is
                        # correct either way
                        continue
                    out[i] = type(groups[i][0])(p)
                    self.combine_device_groups += 1
        for i, g in enumerate(groups):
            if out[i] is None:
                out[i] = self._host_fold(g)
                self.combine_host_groups += 1
        return out

    def combine_many(self, sigs):
        """Synchronous combiner (the `SignatureStore.combiner` hook): one
        group, resolved now — with any accumulated groups riding the same
        launch."""
        group = list(sigs)
        self.combine_groups += 1
        self.combine_points += len(group)
        if self._queue:
            queued, self._queue = self._queue, []
            results = self._resolve(queued + [group])
            self._flushed.extend(results[:-1])
            return results[-1]
        return self._resolve([group])[0]

    def accumulate(self, sigs) -> int:
        """Queue a group for the next flush; returns its result index."""
        group = list(sigs)
        self.combine_groups += 1
        self.combine_points += len(group)
        self._queue.append(group)
        return len(self._queue) - 1

    def flush(self) -> list:
        """Resolve every accumulated group in one launch; returns their
        combined signatures in accumulate order (plus any the last
        `combine_many` already swept up, first)."""
        swept, self._flushed = list(self._flushed), []
        if not self._queue:
            return swept
        queued, self._queue = self._queue, []
        return swept + self._resolve(queued)

    def values(self) -> dict[str, float]:
        return {
            "combineGroups": float(self.combine_groups),
            "combinePoints": float(self.combine_points),
            "combineDeviceGroups": float(self.combine_device_groups),
            "combineHostGroups": float(self.combine_host_groups),
        }


# An async verifier: (msg, registry pubkeys, [(global bitset, signature)]) ->
# list of verdicts. The default wraps Constructor.batch_verify.
AsyncVerifier = Callable[
    [bytes, Sequence[PublicKey], Sequence[tuple[BitSet, Signature]]],
    Awaitable[list[bool]],
]


class BatchProcessing:
    """Evaluator-driven batched verification pipeline.

    Matches evaluatorProcessing's external contract (processing.go:93-287):
    `add` enqueues parsed signatures, a background task scores + verifies them,
    and every verified signature is delivered to `on_verified` (the reference's
    Verified() channel consumed by Handel.rangeOnVerified, handel.go:239-248).
    """

    def __init__(
        self,
        part: BinomialPartitioner,
        constructor: Constructor,
        msg: bytes,
        registry_pubkeys: Sequence[PublicKey],
        evaluator: SigEvaluator,
        on_verified: Callable[[IncomingSig], None],
        *,
        batch_size: int = 16,
        verifier: AsyncVerifier | None = None,
        dedup_cache: VerifiedAggCache | None = None,
        max_pending: int = 4096,
        on_verify_failed: Callable[[IncomingSig], None] | None = None,
        logger: Logger = DEFAULT_LOGGER,
        recorder=None,
        trace_tid: int = 0,
        session: str = "",
        epoch: int = 0,
    ):
        self.part = part
        self.cons = constructor
        self.msg = msg
        self.pubkeys = registry_pubkeys
        self.evaluator = evaluator
        self.on_verified = on_verified
        self.batch_size = batch_size
        self.verifier = verifier or self._default_verifier
        self.log = logger
        self.filter: Filter = IndividualSigFilter()
        self.max_retries = 3  # per-candidate verifier-error retry budget
        self.max_pending = max(1, max_pending)
        # byzantine attribution hook: called with the candidate whose
        # verification FAILED, so the node can penalize the packet origin
        # (core/penalty.py via Handel._on_verify_failed)
        self.on_verify_failed = on_verify_failed
        # verified-aggregate dedup: Handel re-receives the same winning
        # aggregate from several peers per level; each copy this node has
        # already judged short-circuits here instead of burning a device lane
        self.dedup = dedup_cache or VerifiedAggCache()
        # multi-tenant scope (service/): a non-empty session id prefixes
        # every dedup key below, so a cache shared across sessions can
        # never hand one tenant another tenant's verdict. "" keeps the
        # single-tenant key shape byte for byte.
        self.session = session
        # validator-set epoch (lifecycle/epoch.py): a nonzero epoch joins
        # the dedup scope so verdicts never survive a registry rotation —
        # the same bytes against a rotated validator set is a new fact.
        self.epoch = epoch
        # tenant/epoch tags folded into every queue/verify span (built once;
        # the tracing hot path only splats the dict)
        self._span_tags: dict = {}
        if session:
            self._span_tags["session"] = session
        if epoch:
            self._span_tags["epoch"] = epoch
        # dynamic membership: origins known to have left the committee.
        # Their individual sigs are suppressed at intake (gossip keeps
        # re-delivering them long after the member is gone, and each copy
        # would burn a verify lane); aggregates relayed by a departed node
        # still flow: they carry live members' signatures.
        self._departed: set[int] = set()
        self.sig_departed_dropped = 0

        # priority queue of (-score, seq, sig): scored once at enqueue, lazily
        # re-scored at dequeue (see _select_batch). `_live` maps seq -> sig
        # for every entry still pending; its dict insertion order IS arrival
        # order, which makes the flood bound's drop-oldest O(1): evict the
        # first key, and let the heap skip the dead seq lazily at pop.
        # `_todos` stays a plain list for the FIFO subclass, unused here.
        self._heap: list[tuple[int, int, IncomingSig]] = []
        self._live: dict[int, IncomingSig] = {}
        self._dirty = False  # store changed since last rebuild → scores stale
        self._seq = 0
        self._todos: list[IncomingSig] = []
        self._wakeup = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._stopped = False

        # per-contribution queue/verify spans when a flight recorder is
        # attached (core/trace.py), on the node's own trace thread
        self.rec = recorder
        self.tid = trace_tid
        # latency distributions for the monitor's histogram plane: enqueue
        # to selection per candidate, and the verifier wall per launch (the
        # round's verify p50)
        self.hist_queue_wait = LogHistogram()
        self.hist_verify = LogHistogram()

        # reporter counters (processing.go:242-256)
        self.sig_checked_ct = 0
        self.sig_queue_size = 0
        self.sig_suppressed = 0
        self.sig_dropped_overflow = 0
        self.sig_verify_failed = 0
        self.sig_checking_time_ms = 0.0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        self._stopped = True
        self._wakeup.set()

    # -- intake ------------------------------------------------------------

    def add(self, sp: IncomingSig) -> None:
        if self._stopped:
            return
        if sp.individual and sp.origin in self._departed:
            self.sig_departed_dropped += 1
            return
        if self.filter.accept(sp):
            self._enqueue(sp)
            if self._queue_len():
                self._wakeup.set()

    def _enqueue(self, sp: IncomingSig) -> None:
        """Score once and push; worthless candidates die at the door
        (the reference prunes score-0 todos on every pass,
        processing.go:171-220 — here they are pruned at enqueue and again
        at dequeue, never verified). The pending set is BOUNDED: past
        `max_pending` the oldest queued candidate is evicted (drop-oldest —
        under a flood the oldest entries are the stalest, and the
        protocol's periodic resend recovers anything that mattered), so a
        flooder cannot grow host memory."""
        if sp.ms is None:
            self.sig_suppressed += 1
            return
        mark = self.evaluator.evaluate(sp)
        if mark <= 0:
            self.sig_suppressed += 1
            return
        sp.enqueue_ts = trace_now()  # queue-wait start (re-stamped on requeue)
        self._seq += 1
        heapq.heappush(self._heap, (-mark, self._seq, sp))
        self._live[self._seq] = sp
        if len(self._live) > self.max_pending:
            oldest = next(iter(self._live))  # dict order = arrival order
            del self._live[oldest]  # its heap entry dies lazily at pop
            self.sig_dropped_overflow += 1
        if len(self._heap) > 2 * self.max_pending:
            # a sustained flood evicts faster than pops drain: compact the
            # dead heap entries so the heap itself stays bounded. Triggered
            # at most once per max_pending enqueues — O(1) amortized.
            self._heap = [e for e in self._heap if e[1] in self._live]
            heapq.heapify(self._heap)

    def _queue_len(self) -> int:
        return len(self._live)

    def mark_departed(self, origin: int) -> None:
        """Suppress future individual sigs from a departed member (the
        already-queued ones fail no invariants: they just verify and merge,
        which is correct, since the member signed before leaving)."""
        self._departed.add(origin)

    def pending(self) -> list[IncomingSig]:
        """Snapshot of queued candidates (service/session.py pending work)."""
        return list(self._live.values())

    # -- processing loop ---------------------------------------------------

    async def _loop(self) -> None:
        while not self._stopped:
            if not self._queue_len():
                self._wakeup.clear()
                await self._wakeup.wait()
                continue
            batch = self._select_batch()
            if not batch:
                continue
            await self._verify_and_publish(batch)

    def _select_batch(self) -> list[IncomingSig]:
        """Pop the best-scored candidates, re-scoring lazily but EXACTLY.

        The reference's readTodos (processing.go:171-220) re-scores the WHOLE
        queue per pick — O(queue) Python per step melts at a 4000-node flood.
        Here enqueue-time scores order the heap; a popped entry is re-scored
        against the current store and, if its score went stale, re-inserted
        at the fresh score instead of taking a batch slot. The store is fixed
        within one call, so a refreshed entry popped again matches its key
        and is taken — every entry costs at most two pops per call.

        Pop-refresh-reinsert alone is only exact while scores never RISE
        after enqueue (a risen entry keeps its stale-low key and stays
        buried, never reaching the top to be refreshed) — and store scores
        DO rise: a queued sig can jump into the ~1,000,000 level-completion
        bracket as indiv_verified grows (store.py _evaluate). Scores only
        move when the store changes, and the store only changes through the
        on_verified publishes this pipeline itself issues, so
        _verify_and_publish marks the heap dirty after publishing and the
        next call here rebuilds it with fresh scores — one O(queue) rescan
        per *successful batch* (≤ 1/batch_size of the reference's per-pick
        rescan) instead of per pick. The selected batch is therefore exactly
        the current top of the queue. Order fidelity is load-bearing: a
        stale-ordered variant of this loop verified ~4x more signatures per
        node at N=2000 because each check contributed less.
        """
        if self._dirty:
            self._dirty = False
            stale = self._heap
            self._heap = []
            for _, seq, sp in stale:
                if seq not in self._live:
                    continue  # overflow-evicted: already counted at drop
                fresh = self.evaluator.evaluate(sp) if sp.ms is not None else 0
                if fresh <= 0:
                    self.sig_suppressed += 1
                    del self._live[seq]
                else:
                    self._heap.append((-fresh, seq, sp))
            heapq.heapify(self._heap)

        batch: list[IncomingSig] = []
        while self._heap and len(batch) < self.batch_size:
            neg, seq, sp = heapq.heappop(self._heap)
            if seq not in self._live:
                continue  # overflow-evicted: already counted at drop
            fresh = self.evaluator.evaluate(sp) if sp.ms is not None else 0
            if fresh <= 0:
                self.sig_suppressed += 1
                del self._live[seq]
                continue
            if fresh != -neg:
                heapq.heappush(self._heap, (-fresh, seq, sp))
                continue
            del self._live[seq]
            batch.append(sp)

        self.sig_checked_ct += len(batch)
        self.sig_queue_size += self._queue_len()
        return batch

    async def _verify_and_publish(self, batch: list[IncomingSig]) -> None:
        start = time.perf_counter()
        rec = self.rec
        tracing = rec is not None and rec.enabled
        t_deq = trace_now()
        for sp in batch:
            if sp.enqueue_ts:
                self.hist_queue_wait.add(max(0.0, t_deq - sp.enqueue_ts))
                if tracing:
                    rec.span(
                        "queue",
                        sp.enqueue_ts,
                        t_deq,
                        tid=self.tid,
                        cat="pipeline",
                        args={
                            "origin": sp.origin,
                            "level": sp.level,
                            "rts": int(sp.recv_ts * 1e6),
                            "ind": sp.is_ind,
                            "tries": sp.verify_tries,
                            "span": sp.span_id,
                            **self._span_tags,
                        },
                    )
        # Dedup pass: a candidate whose exact content — (level, bitset words,
        # signature bytes) — this node has already judged takes its remembered
        # verdict; duplicates WITHIN the batch ride the first copy's lane.
        # Only the remainder goes to the device.
        oks: list[bool | None] = [None] * len(batch)
        keys: list[tuple] = []
        first_at: dict[tuple, int] = {}
        to_verify: list[int] = []
        for i, sp in enumerate(batch):
            # scope: level alone (single-tenant default, key shape
            # unchanged), else (session, level) or — after a rotation —
            # (session, epoch, level), so an epoch bump invalidates every
            # verdict computed against the previous validator set
            if self.epoch:
                scope = (self.session, self.epoch, sp.level)
            elif self.session:
                scope = (self.session, sp.level)
            else:
                scope = sp.level
            k = VerifiedAggCache.key(scope, sp.ms)
            keys.append(k)
            if k in first_at:
                self.dedup.hits += 1  # in-batch duplicate: zero extra lanes
                continue
            cached = self.dedup.get(k)
            if cached is not None:
                oks[i] = cached
            else:
                first_at[k] = i
                to_verify.append(i)

        if to_verify:
            try:
                requests = [
                    (self._global_bitset(batch[i]), batch[i].ms.signature)
                    for i in to_verify
                ]
                verdicts = await self.verifier(self.msg, self.pubkeys, requests)
                if len(verdicts) != len(to_verify):
                    self.log.error(
                        "verifier_contract",
                        f"{len(verdicts)} verdicts for {len(to_verify)} requests",
                    )
                    verdicts = None
            except Exception as e:
                # A transient verifier error (device hiccup, RPC failure) must
                # not silently discard candidates: requeue the batch with a
                # per-candidate retry cap so the evaluator re-scores it on the
                # next step. (The reference logs per-signature errors and moves
                # on, processing.go:282-284; the protocol's periodic resend is
                # not guaranteed for individual sigs, hence the requeue.)
                self.log.warn("verifier_error", e)
                verdicts = None
            if verdicts is None:
                # requeue every unresolved candidate (the device subset AND
                # its in-batch duplicates); cached verdicts still publish
                self._requeue([sp for sp, ok in zip(batch, oks) if ok is None])
            else:
                for i, ok in zip(to_verify, verdicts):
                    oks[i] = bool(ok)
                    self.dedup.put(keys[i], bool(ok))
        # resolve in-batch duplicates from their first copy's verdict (which
        # stays None — and so requeued, above — if the verifier errored)
        for i, k in enumerate(keys):
            if oks[i] is None and first_at.get(k, i) != i:
                oks[i] = oks[first_at[k]]
        self.sig_checking_time_ms += (time.perf_counter() - start) * 1000.0
        t_verified = trace_now()
        if to_verify:
            # device-verify latency per launch (the round's verify p50)
            self.hist_verify.add(max(0.0, t_verified - t_deq))
        if tracing:
            for sp, ok in zip(batch, oks):
                # dedup-cached candidates resolve at the scan: near-zero span
                rec.span(
                    "verify",
                    t_deq,
                    t_verified,
                    tid=self.tid,
                    cat="pipeline",
                    args={
                        "origin": sp.origin,
                        "level": sp.level,
                        "rts": int(sp.recv_ts * 1e6),
                        "ind": sp.is_ind,
                        "ok": bool(ok) if ok is not None else None,
                        "batch": len(batch),
                        "span": sp.span_id,
                        **self._span_tags,
                    },
                )
                if sp.span_id:
                    # flow step through the verify stage keeps the arrow
                    # alive across the queue reorder (merge emits the "f")
                    rec.flow("contrib", sp.span_id, "t", t_verified, tid=self.tid)

        for sp, ok in zip(batch, oks):
            if ok is None:
                continue  # verifier error: already requeued above
            if ok:
                self.on_verified(sp)
                # the publish mutates the store, which can RAISE queued
                # scores — rebuild before the next selection (_select_batch)
                self._dirty = True
            else:
                self.sig_verify_failed += 1
                # warn-once: a byzantine peer can force unlimited failures;
                # the counter + penalty attribution carry the signal
                log = (
                    self.log.warn
                    if self.sig_verify_failed == 1
                    else self.log.debug
                )
                # the candidate's bytes as received (ROADMAP §C, C6): with
                # the fake scheme a verdict fails only on an empty bitset or
                # a signature whose bytes are not the valid one's
                bs = sp.ms.bitset
                log(
                    "verify_failed",
                    f"origin={sp.origin} level={sp.level} ind={sp.is_ind} "
                    f"bits={bs.cardinality()}/{len(bs)} "
                    f"bitset={bs.marshal().hex()} "
                    f"sig={sp.ms.signature.marshal().hex()}",
                )
                if self.on_verify_failed is not None:
                    # attribute the bad signature to the packet origin so
                    # the node can demote/ban a byzantine peer
                    self.on_verify_failed(sp)

    def _requeue(self, batch: list[IncomingSig]) -> None:
        """Put errored candidates back on the todo queue, up to max_retries
        attempts each; drop (with a log line) beyond that."""
        for sp in batch:
            sp.verify_tries += 1
            tries = sp.verify_tries
            if tries <= self.max_retries:
                self._enqueue(sp)
            else:
                self.log.error(
                    "verify_retries_exhausted",
                    f"origin={sp.origin} level={sp.level} tries={tries}",
                )
        if self._queue_len():
            self._wakeup.set()

    def _global_bitset(self, sp: IncomingSig) -> BitSet:
        """Shift a level-local bitset to registry coordinates
        (the aggregation span of processing.go:342-361)."""
        lo, hi = self.part.range_level(sp.level)
        if len(sp.ms.bitset) != hi - lo:
            raise ValueError("inconsistent bitset with given level")
        out = BitSet(len(self.pubkeys))
        # word-level shift-or: this runs once per device-bound candidate
        out.or_embed(sp.ms.bitset, lo)
        return out

    async def _default_verifier(self, msg, pubkeys, requests):
        return self.cons.batch_verify(msg, pubkeys, requests)

    # -- reporting (processing.go:242-256) ---------------------------------

    def values(self) -> dict[str, float]:
        checked = self.sig_checked_ct
        return {
            "sigCheckedCt": float(checked),
            "sigQueueSize": self.sig_queue_size / checked if checked else 0.0,
            "sigSuppressed": float(self.sig_suppressed),
            "sigDroppedOverflow": float(self.sig_dropped_overflow),
            "sigDepartedDropped": float(self.sig_departed_dropped),
            "sigVerifyFailed": float(self.sig_verify_failed),
            "sigCheckingTime": (
                self.sig_checking_time_ms / checked if checked else 0.0
            ),
            # dedup plane: sigCheckedCt counts SELECTED candidates; subtract
            # dedupHits for actual device verifications
            **self.dedup.values(),
        }

    def gauge_keys(self) -> set[str]:
        """Explicit gauge declarations: the per-candidate averages and the
        dedup cache's point-in-time keys are never delta'd as counters
        (sim/monitor.py CounterIO)."""
        return {"sigQueueSize", "sigCheckingTime"} | self.dedup.gauge_keys()

    def histograms(self) -> dict[str, LogHistogram]:
        """Latency distributions for the monitor's histogram plane."""
        return {
            "queueWaitS": self.hist_queue_wait,
            "verifyLatencyS": self.hist_verify,
        }


class FifoProcessing(BatchProcessing):
    """Arrival-order pipeline without evaluator scoring
    (the reference's deprecated fifoProcessing, processing.go:380-493).

    Kept for A/B comparison against the evaluator strategy (the reference's
    confgenerator sweeps exactly this axis). Batching still applies — the
    first `batch_size` arrivals go to the device together — but nothing is
    suppressed and nothing is reordered, so a flood of stale candidates is
    verified in full.
    """

    def _enqueue(self, sp: IncomingSig) -> None:
        sp.enqueue_ts = trace_now()
        self._todos.append(sp)
        if len(self._todos) > self.max_pending:  # same drop-oldest bound
            self._todos.pop(0)
            self.sig_dropped_overflow += 1

    def _queue_len(self) -> int:
        return len(self._todos)

    def pending(self) -> list[IncomingSig]:
        return list(self._todos)

    def _select_batch(self) -> list[IncomingSig]:
        # drop ms-less entries up front so they neither consume batch slots
        # nor escape the suppressed counter
        usable = [sp for sp in self._todos if sp.ms is not None]
        self.sig_suppressed += len(self._todos) - len(usable)
        batch = usable[: self.batch_size]
        self._todos = usable[self.batch_size :]
        self.sig_checked_ct += len(batch)
        self.sig_queue_size += len(self._todos)
        return batch
