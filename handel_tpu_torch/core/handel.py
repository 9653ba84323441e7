"""The Handel protocol state machine — a copy of handel_tpu/core/handel.py.

Reference: handel.go:15-598 — the `Handel` struct, packet validation/parsing
(:127-152, :373-436), the four concurrent loops started by `Start()` (:156-164),
periodic updates (:167-225), the actor pattern (:257-328: checkCompletedLevel +
checkFinalSignature), per-level send state (:443-580), and level creation with
seeded shuffling (:498-519).

Concurrency redesign: the reference runs four goroutines per node under one
global mutex; here each node is a set of asyncio tasks on a single event loop —
no locks, and many logical nodes can share one loop (and one device)
in-process. Verified signatures flow back via a direct callback
(`_on_verified`) instead of a channel.

Cut from the JAX package's Handel, with the plane they serve (ROADMAP item
8e, swarm): the windowed store and the external timer wheel.
"""

from __future__ import annotations

import asyncio
import time
from typing import Sequence

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.config import Config, merge_with_default
from handel_tpu_torch.core.crypto import Constructor, MultiSignature, Signature
from handel_tpu_torch.core.identity import Identity, Registry, shuffle
from handel_tpu_torch.core.net import Network, Packet
from handel_tpu_torch.core.partitioner import BinomialPartitioner, IncomingSig
from handel_tpu_torch.core.penalty import (
    WEIGHT_PARSE_FAIL,
    PeerScorer,
)
from handel_tpu_torch.core.processing import BatchProcessing, CombineShim
from handel_tpu_torch.core.report import WarnOnce
from handel_tpu_torch.core.store import SignatureStore
from handel_tpu_torch.core.timeout import LinearTimeout
from handel_tpu_torch.core.trace import LogHistogram, trace_now


class Level:
    """Per-level send/receive state (handel.go:443-580)."""

    def __init__(
        self,
        id: int,
        nodes: Sequence[Identity],
        send_expected_full_size: int,
        scorer: PeerScorer | None = None,
    ):
        if id <= 0:
            raise ValueError("level id must be >= 1")
        self.id = id
        # any indexable sequence works (list, RegistrySlice): a lazy range
        # view instead of a copy keeps a level O(1) memory
        self.nodes = nodes if hasattr(nodes, "__getitem__") else list(nodes)
        # dynamic membership: global ids of members of THIS level that left
        # mid-aggregation. They are skipped in peer selection and excluded
        # from the receive-complete count: the level's effective size
        # shrinks without rebuilding the partitioner.
        self.departed: set[int] = set()
        self.send_started = False
        self.rcv_completed = False
        self.send_pos = 0
        self.send_peers_ct = 0
        self.send_expected_full_size = send_expected_full_size
        self.send_sig_size = 0
        # peer penalty plane (core/penalty.py): banned peers are skipped,
        # demoted peers get every other update
        self.scorer = scorer
        self._demote_tick: dict[int, int] = {}
        self.banned_skips = 0
        self.demote_skips = 0

    def active(self) -> bool:
        """Started and not yet done contacting every peer with the current
        signature (handel.go:526-528)."""
        return self.send_started and self.send_peers_ct < len(self.nodes)

    def set_started(self) -> None:
        self.send_started = True

    def select_next_peers(self, count: int) -> list[Identity]:
        """Rolling window over the (shuffled) peer list (handel.go:544-558).

        With a scorer attached, banned peers never get a slot (sending to a
        peer we refuse to hear from is pure waste) and demoted peers are
        handed only every other update — offenders fall behind honest peers
        without being cut off on a single bad packet. The scan is bounded so
        an all-banned level degrades to an empty selection, not a spin.
        """
        size = min(count, len(self.nodes))
        if self.scorer is None and not self.departed:
            res = []
            for _ in range(size):
                res.append(self.nodes[self.send_pos])
                self.send_pos = (self.send_pos + 1) % len(self.nodes)
            self.send_peers_ct += size
            return res

        res: list[Identity] = []
        # at most one full pass: each peer considered once per selection, so
        # skips shrink the selection instead of double-sending to survivors
        for _ in range(len(self.nodes)):
            if len(res) >= size:
                break
            peer = self.nodes[self.send_pos]
            self.send_pos = (self.send_pos + 1) % len(self.nodes)
            if peer.id in self.departed:
                continue  # a gone member: a packet there is pure loss
            if self.scorer is not None and self.scorer.banned(peer.id):
                self.banned_skips += 1
                continue
            if self.scorer is not None and self.scorer.demoted(peer.id):
                tick = self._demote_tick.get(peer.id, 0) + 1
                self._demote_tick[peer.id] = tick
                if tick % 2 == 1:
                    self.demote_skips += 1
                    continue
            res.append(peer)
        self.send_peers_ct += size
        return res

    def expected_members(self) -> int:
        """Members that can still contribute: level size minus departures."""
        return len(self.nodes) - len(self.departed)

    def update_sig_to_send(self, sig: MultiSignature) -> bool:
        """Track the best signature we can send at this level; reset the peer
        counter on improvement so the better sig propagates. Returns True when
        the sendable signature is complete (fast-path start, handel.go:565-580)."""
        card = sig.cardinality()
        if self.send_sig_size >= card:
            return False
        self.send_sig_size = card
        self.send_peers_ct = 0
        if self.send_sig_size == self.send_expected_full_size:
            self.set_started()
            return True
        return False


def create_levels(
    config: Config, partitioner, scorer: PeerScorer | None = None
) -> dict[int, Level]:
    """Build all levels, shuffling candidate order per level (handel.go:498-519).

    send_expected_full_size accumulates 1 (own sig) + the sizes of all lower
    levels — the complete signature one can send at each level.
    """
    levels: dict[int, Level] = {}
    first_active = False
    send_expected_full_size = 1
    for lvl in partitioner.levels():
        nodes = partitioner.identities_at(lvl)
        if not config.disable_shuffling:
            # shuffling forces a real copy; with it disabled the
            # partitioner's O(1) range view is kept as-is
            nodes = list(nodes)
            shuffle(nodes, config.rand)
        levels[lvl] = Level(lvl, nodes, send_expected_full_size, scorer)
        if config.disable_shuffling:
            # un-shuffled candidate order is IDENTICAL for every node in a
            # sibling subtree, so a send_pos of 0 would aim the whole
            # subtree's fast-path burst at the level's first `count`
            # candidates and starve the rest until gossip rotates there.
            # Deriving the rotation start from our own id spreads the burst
            # uniformly with none of shuffling's per-node list copies.
            levels[lvl].send_pos = partitioner.id % len(nodes)
        send_expected_full_size += len(nodes)
        if not first_active:
            levels[lvl].set_started()
            first_active = True
    return levels


class Handel:
    """One logical aggregation node (handel.go:15-62).

    Consume final multisignatures from `final_signatures` (an asyncio.Queue,
    the reference's FinalSignatures() channel, handel.go:230-232).
    """

    def __init__(
        self,
        network: Network,
        registry: Registry,
        identity: Identity,
        constructor: Constructor,
        msg: bytes,
        own_sig: Signature,
        config: Config | None = None,
    ):
        self.c = merge_with_default(config, registry.size())
        self.net = network
        self.reg = registry
        self.id = identity
        self.cons = constructor
        self.msg = msg
        self.sig = own_sig
        self.log = self.c.logger.with_fields(id=identity.id)

        # byzantine peer accounting (core/penalty.py): failed verifications
        # and unparseable packets are attributed back to the packet origin;
        # the service's sessions pass their session's scorer (new_scorer)
        self.scorer = self.c.new_scorer(self) if self.c.new_scorer else PeerScorer()

        self.partitioner = BinomialPartitioner(identity.id, registry, self.log)
        self.levels = create_levels(self.c, self.partitioner, self.scorer)
        self.ids = self.partitioner.levels()
        self.threshold = self.c.contributions
        self.done = False
        self.start_time = 0.0
        self.best: MultiSignature | None = None
        self.final_signatures: asyncio.Queue[MultiSignature] = asyncio.Queue()

        # span flight recorder (core/trace.py): shared across co-located
        # nodes, this node's events keyed by its id as the Chrome-trace tid.
        # None = tracing off; the hot-path hooks cost one None check.
        self.rec = self.c.recorder
        self._tid = identity.id
        if self.rec is not None:
            self.rec.name_thread(self._tid, f"node-{identity.id}")
        # outbound flow-link ids: (node id << 40) | seq is unique fleet-wide
        # without coordination; generated only while tracing, so untraced
        # packets stay span_id=0 (no trailer on the wire)
        self._span_seq = 0
        # session/epoch tags folded into span args end to end (multi-tenant
        # runs; the epoch marks which validator set served this node)
        self._sargs = {"session": self.c.session} if self.c.session else {}
        if self.c.epoch:
            self._sargs = {**self._sargs, "epoch": self.c.epoch}
        if self.c.region:
            # WAN region tag (network/geo.py): rides every span this node
            # emits so the critical-path analyzer can attribute hops to
            # region pairs (sender's send span vs receiver's recv span)
            self._sargs = {**self._sargs, "region": self.c.region}

        # batched aggregate combine: device constructors expose
        # `device_combine`, and the shim routes the store's merge/patch
        # point-addition chains through one combine_batch launch per group
        # instead of one host add per contribution; host constructors get
        # no shim and the store keeps its serial path
        self.combine_shim = CombineShim.for_constructor(constructor)
        self.store = SignatureStore(
            self.partitioner,
            BitSet,
            constructor,
            combiner=(
                self.combine_shim.combine_many if self.combine_shim else None
            ),
            weights=self.c.weights,
        )
        # stake-weighted threshold: with a weight vector set, the
        # final-signature gate compares accumulated stake against
        # `weight_threshold`, by default the same fraction of total stake
        # that `contributions` is of the node count, computed as
        # (threshold * total) / n so all-1.0 weights yield exactly the
        # integer count threshold (no float drift on the no-op path).
        self.weights = self.c.weights
        self.weight_threshold = 0.0
        self.total_weight = 0.0
        if self.weights is not None:
            self.total_weight = float(sum(self.weights))
            self.weight_threshold = self.c.weight_threshold or (
                self.threshold * self.total_weight / registry.size()
            )
        # dynamic membership: global ids known to have left mid-run (the
        # scenario engine and churner adversaries broadcast departures)
        self.departed: set[int] = set()
        self.threshold_unreachable_ct = 0
        # our own signature seeds the store at level 0 (handel.go:108-116)
        first_bs = BitSet(1)
        first_bs.set(0, True)
        self.store.store(
            IncomingSig(
                origin=identity.id,
                level=0,
                ms=MultiSignature(first_bs, own_sig),
                is_ind=True,
                mapped_index=0,
            )
        )

        evaluator = (
            self.c.new_evaluator(self.store, self)
            if self.c.new_evaluator
            else self.store
        )
        processing_cls = self.c.new_processing or BatchProcessing
        self.proc = processing_cls(
            self.partitioner,
            constructor,
            msg,
            registry.public_keys(),
            evaluator,
            self._on_verified,
            batch_size=self.c.batch_size,
            verifier=self.c.verifier,
            max_pending=self.c.max_pending,
            on_verify_failed=self._on_verify_failed,
            logger=self.log,
            recorder=self.rec,
            trace_tid=self._tid,
            session=self.c.session,
            epoch=self.c.epoch,
        )
        self.net.register_listener(self)
        self.timeout = (
            self.c.new_timeout(self, self.ids)
            if self.c.new_timeout
            else LinearTimeout(self, self.ids, self.c.level_timeout)
        )

        # minimal stats (handel.go:594-598) + reporter hook
        self.msg_sent_ct = 0
        self.msg_rcv_ct = 0
        self.invalid_packet_ct = 0
        self.banned_packet_ct = 0
        # warn-once log keys: a flooder spamming malformed packets must not
        # turn the log itself into the DoS — first offense per reason is
        # WARN, the rest are debug + the logWarnCt counter (core/report.py)
        self._warn = WarnOnce(self.log)
        self._periodic_task: asyncio.Task | None = None
        # seconds from start() to each level's receive completion, on the
        # monitor's histogram plane
        self.hist_level_complete = LogHistogram()

    # -- lifecycle (handel.go:156-182) -------------------------------------

    def start(self) -> None:
        """Start processing, timeouts and the periodic updater. Must be called
        from a running asyncio event loop."""
        self.start_time = time.monotonic()
        self.proc.start()
        self.timeout.start()
        self._periodic_task = asyncio.get_running_loop().create_task(
            self._periodic_loop()
        )

    def stop(self) -> None:
        self.timeout.stop()
        self.proc.stop()
        if self._periodic_task is not None:
            self._periodic_task.cancel()
            self._periodic_task = None
        self.done = True

    async def _periodic_loop(self) -> None:
        while True:
            await asyncio.sleep(self.c.update_period)
            self._periodic_update()

    def _periodic_update(self) -> None:
        """Gossip our best combined sig on every active level (handel.go:186-194)."""
        for lvl in self.levels.values():
            if lvl.active():
                self._send_update(lvl, self.c.update_count)

    # -- inbound path (handel.go:127-152) ----------------------------------

    def new_packet(self, p: Packet) -> None:
        if self.done:
            return
        rec = self.rec
        tracing = rec is not None and rec.enabled
        t0 = trace_now() if tracing else 0.0
        try:
            self._validate_packet(p)
        except ValueError as e:
            self.invalid_packet_ct += 1
            self._warn_once("invalid_packet", e)
            return
        try:
            ms, ind = self._parse_signatures(p)
        except ValueError as e:
            self.invalid_packet_ct += 1
            self._warn_once("invalid_packet_multisig", e)
            # an unparseable payload from an in-range origin is attributed
            # (at low weight — a corrupting link blames an honest sender)
            self.scorer.report(p.origin, WEIGHT_PARSE_FAIL)
            return
        if tracing:
            # the sender's stamp lines the network-transit span up with our
            # local spans (both sides use the shared epoch trace clock)
            if p.sent_ts and p.sent_ts <= t0:
                rec.span(
                    "net_transit",
                    p.sent_ts,
                    t0,
                    tid=self._tid,
                    cat="net",
                    args={
                        "origin": p.origin,
                        "level": p.level,
                        "span": p.span_id,
                        **self._sargs,
                    },
                )
            ms.recv_ts = t0
            ms.span_id = p.span_id
            if ind is not None:
                ind.recv_ts = t0
                ind.span_id = p.span_id
        if not self.levels[p.level].rcv_completed:
            self.proc.add(ms)
            if ind is not None:
                self.proc.add(ind)
            if tracing:
                # `rts` (arrival stamp, µs) discriminates re-deliveries of
                # the same (origin, level) so the trace CLI reconstructs
                # each physical contribution's chain separately
                t1 = trace_now()
                rec.span(
                    "recv",
                    t0,
                    t1,
                    tid=self._tid,
                    cat="pipeline",
                    args={
                        "origin": p.origin,
                        "level": p.level,
                        "rts": int(t0 * 1e6),
                        "span": p.span_id,
                        "hop": p.hop,
                        **self._sargs,
                    },
                )
                if p.span_id:
                    # flow step: binds the sender's `send` arrow into this
                    # recv span ("t" + bp:e attaches to the enclosing slice)
                    rec.flow("contrib", p.span_id, "t", t1, tid=self._tid)

    def _warn_once(self, key: str, detail) -> None:
        """WARN on the first occurrence per reason, debug + counter after —
        a flooder cannot turn per-packet logging into the attack, and the
        suppressed volume stays visible as `logWarnCt` in `values()`."""
        self._warn.warn(key, detail)

    def _validate_packet(self, p: Packet) -> None:
        """Origin/level range + byzantine checks (handel.go:373-386), all
        BEFORE any signature bytes are parsed: a reflected or spoofed-origin
        packet costs an integer compare, never an unmarshal."""
        self.msg_rcv_ct += 1
        if p.origin < 0 or p.origin >= self.reg.size():
            raise ValueError("packet's origin out of range")
        if p.origin == self.id.id:
            raise ValueError("packet claims to originate from this node")
        if self.scorer.banned(p.origin):
            self.banned_packet_ct += 1
            raise ValueError(f"origin {p.origin} is banned")
        if p.level not in self.levels:
            raise ValueError(f"invalid packet level {p.level}")

    def _parse_signatures(
        self, p: Packet
    ) -> tuple[IncomingSig, IncomingSig | None]:
        """Unmarshal + sanity-check the multisig and optional individual sig
        (handel.go:390-436)."""
        ms = MultiSignature.unmarshal(p.multisig, self.cons)
        lvl = self.levels[p.level]
        if len(ms.bitset) != len(lvl.nodes):
            raise ValueError("invalid bitset size for given level")
        if ms.bitset.cardinality() == 0:
            raise ValueError("no signature in the bitset")
        inc = IncomingSig(origin=p.origin, level=p.level, ms=ms)

        if p.individual_sig is None:
            return inc, None
        if len(p.individual_sig) != self.cons.signature_size():
            raise ValueError("individual signature has wrong wire size")
        individual = self.cons.unmarshal_signature(p.individual_sig)
        level_index = self.partitioner.index_at_level(p.origin, p.level)
        bs = BitSet(len(lvl.nodes))
        bs.set(level_index, True)
        ind = IncomingSig(
            origin=p.origin,
            level=p.level,
            ms=MultiSignature(bs, individual),
            is_ind=True,
            mapped_index=level_index,
        )
        return inc, ind

    # -- verified-signature actors (handel.go:239-328) ---------------------

    def _on_verified(self, sp: IncomingSig) -> None:
        """Store the verified signature, then run the actors
        (rangeOnVerified, handel.go:239-248)."""
        rec = self.rec
        if rec is not None and rec.enabled:
            t0 = trace_now()
            self.store.store(sp)
            self._check_completed_level(sp)
            self._check_final_signature(sp)
            t1 = trace_now()
            rec.span(
                "merge",
                t0,
                t1,
                tid=self._tid,
                cat="pipeline",
                args={
                    "origin": sp.origin,
                    "level": sp.level,
                    "rts": int(sp.recv_ts * 1e6),
                    "ind": sp.is_ind,
                    "span": sp.span_id,
                    **self._sargs,
                },
            )
            if sp.span_id:
                # flow finish: the inbound contribution's causal chain ends
                # where it lands in the store (fast-path sends that happened
                # inside this merge already opened their own outbound flows)
                rec.flow("contrib", sp.span_id, "f", t1, tid=self._tid)
            return
        self.store.store(sp)
        self._check_completed_level(sp)
        self._check_final_signature(sp)

    def _on_verify_failed(self, sp: IncomingSig) -> None:
        """A candidate failed its pairing check: penalize the packet origin
        (honest nodes only forward verified content, so a bad signature is
        strong evidence against the sender — core/penalty.py)."""
        if sp.origin >= 0:
            self.scorer.report(sp.origin)

    def _check_final_signature(self, sp: IncomingSig) -> None:
        """Emit a new best full signature above the threshold (handel.go:271-296).

        With stake weights the gate is the accumulated weight against
        `weight_threshold`; the count path is untouched when `weights` is
        None, and all-1.0 weights make both gates open at the same instant.
        """
        card = self.store.full_cardinality()
        if self.weights is not None:
            if self.store.full_weight(self.weights) < self.weight_threshold:
                return
        elif card < self.threshold:
            return
        if self.best is not None and card <= self.best.cardinality():
            return
        if self.done:
            return
        sig = self.store.full_signature()
        if sig is None:
            return
        first = self.best is None
        self.best = sig
        self.log.info(
            "new_sig",
            f"{sig.cardinality()}/{self.threshold}/{self.reg.size()}",
        )
        if first and self.rec is not None:
            # the critical-path walk (sim/trace_cli.py) anchors on the
            # earliest of these across the fleet's node files
            self.rec.instant(
                "threshold_reached",
                tid=self._tid,
                cat="protocol",
                args={
                    "card": sig.cardinality(),
                    "threshold": self.threshold,
                    **self._sargs,
                },
            )
        self.final_signatures.put_nowait(sig)

    def _check_completed_level(self, sp: IncomingSig) -> None:
        """Mark levels receive-complete and fast-path-forward improved combined
        signatures upward (handel.go:301-328)."""
        lvl = self.levels[sp.level] if sp.level in self.levels else None
        if lvl is not None:
            if lvl.rcv_completed:
                return
            self._maybe_complete_level(sp.level, lvl)

        for lid, up in self.levels.items():
            if lid < sp.level + 1:
                continue
            self._fastpath_level(lid, up)

    def _maybe_complete_level(self, lid: int, lvl: Level) -> None:
        """Mark a level receive-complete when the best covers every member
        that can still contribute: with departures the effective size
        shrinks, so a level missing only gone members completes instead of
        waiting forever on signatures that will never come."""
        best = self.store.best(lid)
        if best is None or best.cardinality() < lvl.expected_members():
            return
        self.log.debug("level_complete", lid)
        lvl.rcv_completed = True
        self.hist_level_complete.add(time.monotonic() - self.start_time)
        if self.rec is not None:
            self.rec.instant(
                "level_complete",
                tid=self._tid,
                cat="protocol",
                args={"level": lid},
            )

    def _fastpath_level(self, lid: int, up: Level) -> None:
        # update_sig_to_send rejects anything not strictly better than
        # what this level already propagated; the disjoint-range
        # cardinality sum answers that without paying for the combine
        if self.store.combined_cardinality(lid - 1) <= up.send_sig_size:
            return
        ms = self.store.combined(lid - 1)
        if ms is not None and up.update_sig_to_send(ms):
            self._send_update(up, self.c.fast_path)

    # -- dynamic membership ------------------------------------------------

    def mark_departed(self, node_id: int) -> None:
        """Record that `node_id` left the committee mid-aggregation.

        Re-levels without rebuilding the partitioner: the member's level
        shrinks (peer selection skips it, receive-completion stops waiting
        for it), its future individual sigs are suppressed in the pipeline,
        and the threshold is re-evaluated against what the remaining
        membership can still deliver. Idempotent; contributions the member
        delivered before leaving keep counting: a signature is a fact.
        """
        if node_id == self.id.id or node_id in self.departed:
            return
        self.departed.add(node_id)
        mark = getattr(self.proc, "mark_departed", None)
        if mark is not None:
            mark(node_id)
        for lid, lvl in self.levels.items():
            lo, hi = self.partitioner.range_level(lid)
            if lo <= node_id < hi:
                lvl.departed.add(node_id)
                if not lvl.rcv_completed:
                    self._maybe_complete_level(lid, lvl)
                    if lvl.rcv_completed:
                        # completing a level can unlock upward fast paths
                        for uid, up in self.levels.items():
                            if uid > lid:
                                self._fastpath_level(uid, up)
                break
        self._recheck_threshold_reachable()

    def _recheck_threshold_reachable(self) -> None:
        """Departure-time threshold re-evaluation: can the remaining
        membership still reach the (weighted) threshold? Banked
        contributions from departed members still count; only their
        missing, never-coming contributions are written off."""
        full = self.store.full_signature()
        have = full.bitset if full is not None else None

        def missing(d: int) -> bool:
            return have is None or not have.get(d)

        if self.weights is not None:
            gone = sum(float(self.weights[d]) for d in self.departed if missing(d))
            unreachable = self.total_weight - gone < self.weight_threshold
        else:
            gone_ct = sum(1 for d in self.departed if missing(d))
            unreachable = self.reg.size() - gone_ct < self.threshold
        if unreachable:
            self.threshold_unreachable_ct += 1
            self._warn_once(
                "threshold_unreachable",
                f"{len(self.departed)} departures leave the threshold "
                f"unreachable for the remaining membership",
            )

    # -- outbound path (handel.go:198-225, 343-368) ------------------------

    def start_level(self, level: int) -> None:
        """Timeout-strategy entry: begin sending for a level (handel.go:198-212)."""
        lvl = self.levels.get(level)
        if lvl is None or lvl.send_started:
            return
        lvl.set_started()
        self._send_update(lvl, self.c.update_count)

    def _send_update(self, lvl: Level, count: int) -> None:
        """Send our best combined signature to the next `count` peers of the
        level (handel.go:216-225)."""
        ms = self.store.combined(lvl.id - 1)
        if ms is None:
            return
        peers = lvl.select_next_peers(count)
        # attach our individual sig until the level completes (handel.go:219-223)
        ind = self.sig if not lvl.rcv_completed else None
        self._send_to(lvl.id, peers, ms, ind)

    def _send_to(
        self,
        level: int,
        ids: Sequence[Identity],
        ms: MultiSignature,
        ind: Signature | None,
    ) -> None:
        if not ids:
            return
        rec = self.rec
        tracing = rec is not None and rec.enabled
        if tracing:
            self._span_seq += 1
            sid = (self.id.id << 40) | self._span_seq
            t0 = trace_now()
        else:
            sid = 0
        self.msg_sent_ct += len(ids)
        p = Packet(
            origin=self.id.id,
            level=level,
            multisig=ms.marshal(),
            individual_sig=ind.marshal() if ind is not None else None,
            # stamped with the shared trace clock, as the JAX package's
            # nodes stamp theirs (a tracing receiver lines up transit spans)
            sent_ts=trace_now(),
            span_id=sid,
            # an aggregate of >1 contributions carries earlier hops
            hop=1 if sid and ms.cardinality() > 1 else 0,
        )
        self.net.send(ids, p)
        if tracing:
            t1 = trace_now()
            rec.span(
                "send",
                t0,
                t1,
                tid=self._tid,
                cat="pipeline",
                args={
                    "level": level,
                    "card": ms.cardinality(),
                    "peers": len(ids),
                    "span": sid,
                    **self._sargs,
                },
            )
            # flow start: receivers' recv/merge steps bind to this span
            rec.flow("contrib", sid, "s", t0, tid=self._tid)

    # -- reporting ---------------------------------------------------------

    def values(self) -> dict[str, float]:
        out = {
            "msgSentCt": float(self.msg_sent_ct),
            "msgRcvCt": float(self.msg_rcv_ct),
            "invalidPacketCt": float(self.invalid_packet_ct),
            "bannedPacketCt": float(self.banned_packet_ct),
            # aggregation progress: levels fully received, best cardinality
            "levelsCompletedCt": float(
                sum(1 for l in self.levels.values() if l.rcv_completed)
            ),
            "bestCardinality": float(
                self.best.cardinality() if self.best is not None else 0
            ),
            # dynamic membership
            "departedCt": float(len(self.departed)),
            "thresholdUnreachableCt": float(self.threshold_unreachable_ct),
            **self._warn.values(),
            **self.proc.values(),
            **self.store.values(),
            **(self.combine_shim.values() if self.combine_shim else {}),
        }
        out.update(self.scorer.values())
        out["peerBannedSkips"] = float(
            sum(lvl.banned_skips for lvl in self.levels.values())
        )
        out["peerDemoteSkips"] = float(
            sum(lvl.demote_skips for lvl in self.levels.values())
        )
        return out

    def gauge_keys(self) -> set[str]:
        """Point-in-time keys, never delta'd as counters (sim/monitor.py
        CounterIO)."""
        return (
            {"bestCardinality"}
            | self.proc.gauge_keys()
            | self.scorer.gauge_keys()
        )

    def histograms(self) -> dict[str, LogHistogram]:
        """Latency distributions for the monitor's histogram plane
        (sim/monitor.py HistogramIO -> `_p50/_p90/_p99` CSV columns)."""
        return {
            "levelCompleteS": self.hist_level_complete,
            **self.proc.histograms(),
        }
