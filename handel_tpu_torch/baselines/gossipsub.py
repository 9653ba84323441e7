"""Gossipsub aggregation baseline — the libp2p comparison protocol; a copy
of handel_tpu/baselines/gossipsub.py.

Reference: simul/p2p/libp2p/node.go:55-434 — each node publishes its
individual signature on its OWN topic and subscribes to every other node's
topic (SubscribeToAll); a setup barrier (special Level=255 packets,
WaitAllSetup) holds publishing until the overlay is known-complete; local
aggregation fires at threshold. The transport there is libp2p's gossipsub
router; this module implements that router's v1.0 semantics directly on the
framework's Packet wire format instead of standing in with plain flooding:

  * per-topic MESH overlays with degree bounds: GRAFT to D when below D_lo,
    PRUNE to D when above D_hi, on a heartbeat (gossipsub §mesh maintenance);
  * eager push: full messages forward once to the topic's mesh members;
  * lazy pull: each heartbeat, IHAVE (seen message ids) goes to D_lazy
    random non-mesh peers, who answer IWANT for what they miss — the repair
    channel that makes the protocol survive UDP loss;
  * SUB announce + setup barrier before the first publish.

Message ids are topic ids (one signature per origin-topic), so IHAVE/IWANT
carry plain topic lists. Control frames ride `Packet.multisig` with a
1-byte type tag under level=254; the data frame carries the marshaled
individual signature. Verification is verify-on-arrival (the reference's
default aggregator mode, simul/p2p/aggregator.go verifyPacket).
"""

from __future__ import annotations

import asyncio
import random
import struct
from typing import Sequence

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.crypto import Constructor, MultiSignature
from handel_tpu_torch.core.identity import Identity, Registry
from handel_tpu_torch.core.net import Network, Packet

GOSSIPSUB_LEVEL = 254  # the baseline's private level marker (node.go: 255)

# frame types
_SUB = 0  # subscription announce (setup barrier)
_PUB = 1  # full message: topic's individual signature
_GRAFT = 2
_PRUNE = 3
_IHAVE = 4
_IWANT = 5


def _frame(kind: int, topic: int, payload: bytes = b"") -> bytes:
    return struct.pack(">BI", kind, topic) + payload


def _topics_payload(topics) -> bytes:
    return struct.pack(">H", len(topics)) + b"".join(
        struct.pack(">I", t) for t in topics
    )


def _parse_topics(payload: bytes) -> list[int]:
    (n,) = struct.unpack_from(">H", payload, 0)
    return [struct.unpack_from(">I", payload, 2 + 4 * i)[0] for i in range(n)]


class GossipSubAggregator:
    """One gossipsub node (node.go P2PNode + the gossipsub router itself).

    Same constructor shape as baselines/gossip.py GossipAggregator so the
    sim node binary and the test harness drive either interchangeably.
    """

    def __init__(
        self,
        network: Network,
        registry: Registry,
        identity: Identity,
        constructor: Constructor,
        msg: bytes,
        own_sig,
        threshold: int,
        *,
        heartbeat: float = 0.05,
        degree: int = 6,  # gossipsub D
        degree_lo: int = 4,  # D_lo
        degree_hi: int = 12,  # D_hi
        degree_lazy: int = 6,  # D_lazy (IHAVE fanout)
        rand: random.Random | None = None,
    ):
        self.net = network
        self.reg = registry
        self.id = identity.id
        self.cons = constructor
        self.msg = msg
        self.threshold = threshold
        self.heartbeat = heartbeat
        self.D, self.D_lo, self.D_hi = degree, degree_lo, degree_hi
        self.D_lazy = degree_lazy
        self.rand = rand or random.Random(identity.id)

        # delivered messages: topic (origin id) -> verified signature
        self.sigs: dict[int, object] = {identity.id: own_sig}
        # gossip history window (the spec's mcache): IHAVE advertises only
        # ids learned in the last `history` heartbeats plus our own topic —
        # a full-set advertisement would be O(N) bytes per frame per beat
        # at reference scale (4000 topics = 16 KB fragmenting UDP frames)
        self.history = 6
        self._beat = 0
        self._learned_at: dict[int, int] = {identity.id: 0}
        # per-topic mesh membership (only topics with traffic materialize;
        # the reference's libp2p router does the same lazily per topic)
        self.mesh: dict[int, set[int]] = {}
        # peers whose SUB we've seen — the setup barrier state
        self.subscribed: set[int] = {identity.id}
        self.setup_complete = False

        self.final: asyncio.Future = asyncio.get_event_loop().create_future()
        self._task: asyncio.Task | None = None
        # counters for the monitor plane
        self.sigs_checked = 0
        self.grafts_sent = 0
        self.prunes_sent = 0
        self.ihave_sent = 0
        self.iwant_sent = 0
        network.register_listener(self)

    # -- wire in -------------------------------------------------------------

    def new_packet(self, packet: Packet) -> None:
        if packet.level != GOSSIPSUB_LEVEL or packet.origin == self.id:
            return
        data = packet.multisig
        if len(data) < 5:
            return
        kind, topic = struct.unpack_from(">BI", data, 0)
        payload = data[5:]
        peer = packet.origin
        # ANY valid frame proves the peer is up and subscribed — without
        # this, a peer whose SUB frames were all lost before the sender
        # completed setup would stall forever (the sender stops announcing
        # but keeps heartbeating GRAFT/IHAVE/PUB traffic we can learn from)
        self.subscribed.add(peer)  # _SUB frames carry nothing else
        if kind == _PUB:
            self._deliver(topic, payload, from_peer=peer)
        elif kind == _GRAFT:
            # gossipsub accepts grafts immediately; overshoot beyond D_hi is
            # corrected at the next heartbeat's prune pass
            self.mesh.setdefault(topic, set()).add(peer)
        elif kind == _PRUNE:
            self.mesh.get(topic, set()).discard(peer)
        elif kind in (_IHAVE, _IWANT):
            # a truncated control payload must not raise out of the
            # transport's listener callback — drop the frame, like the
            # unmarshal_signature guard in _deliver
            try:
                topics = _parse_topics(payload)
            except struct.error:
                return
            if kind == _IHAVE:
                missing = [t for t in topics if t not in self.sigs]
                if missing:
                    self.iwant_sent += 1
                    self._send(
                        peer, _frame(_IWANT, 0, _topics_payload(missing))
                    )
            else:
                for t in topics:
                    sig = self.sigs.get(t)
                    if sig is not None:
                        self._send(peer, _frame(_PUB, t, sig.marshal()))

    def _deliver(self, topic: int, sig_bytes: bytes, from_peer: int) -> None:
        if topic in self.sigs or not (0 <= topic < self.reg.size()):
            return
        try:
            sig = self.cons.unmarshal_signature(sig_bytes)
        except Exception:
            return
        pk = self.reg.identity(topic).public_key
        self.sigs_checked += 1
        if not pk.verify(self.msg, sig):
            return
        self.sigs[topic] = sig
        self._learned_at[topic] = self._beat
        # eager push: forward once to the topic's mesh (minus the sender)
        self._publish_to_mesh(topic, sig, exclude=from_peer)
        self._maybe_finish()

    # -- wire out ------------------------------------------------------------

    def _send(self, peer: int, frame: bytes) -> None:
        self.net.send(
            [self.reg.identity(peer)],
            Packet(origin=self.id, level=GOSSIPSUB_LEVEL, multisig=frame),
        )

    def _send_many(self, peers: Sequence[int], frame: bytes) -> None:
        if peers:
            self.net.send(
                [self.reg.identity(p) for p in peers],
                Packet(origin=self.id, level=GOSSIPSUB_LEVEL, multisig=frame),
            )

    def _publish_to_mesh(self, topic: int, sig, exclude: int = -1) -> None:
        members = self._mesh_of(topic)
        self._send_many(
            [p for p in members if p != exclude], _frame(_PUB, topic, sig.marshal())
        )

    def _mesh_of(self, topic: int) -> set[int]:
        """Materialize a topic mesh on first touch: graft D random peers
        (what libp2p does on subscribe/first message)."""
        members = self.mesh.get(topic)
        if members is None:
            members = set(self._sample_peers(self.D, excluding=set()))
            self.mesh[topic] = members
            for p in members:
                self.grafts_sent += 1
                self._send(p, _frame(_GRAFT, topic))
        return members

    def _sample_peers(self, k: int, excluding: set[int]) -> list[int]:
        pool = [
            i
            for i in range(self.reg.size())
            if i != self.id and i not in excluding
        ]
        return self.rand.sample(pool, min(k, len(pool)))

    # -- heartbeat -----------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.get_event_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task:
            self._task.cancel()

    async def _loop(self) -> None:
        sub_frame = _frame(_SUB, self.id)
        while True:
            if not self.setup_complete:
                # setup barrier (node.go WaitAllSetup): announce until the
                # whole registry is known-subscribed, then start publishing
                self._send_many(
                    [i for i in range(self.reg.size()) if i != self.id],
                    sub_frame,
                )
                if len(self.subscribed) == self.reg.size():
                    self.setup_complete = True
                    self._publish_to_mesh(self.id, self.sigs[self.id])
            else:
                self._heartbeat()
            self._maybe_finish()
            await asyncio.sleep(self.heartbeat)

    def _heartbeat(self) -> None:
        self._beat += 1
        # mesh maintenance per active topic (gossipsub §heartbeat)
        for topic, members in self.mesh.items():
            if len(members) < self.D_lo:
                added = self._sample_peers(
                    self.D - len(members), excluding=members
                )
                members.update(added)
                for p in added:
                    self.grafts_sent += 1
                    self._send(p, _frame(_GRAFT, topic))
            elif len(members) > self.D_hi:
                drop = self.rand.sample(sorted(members), len(members) - self.D)
                members.difference_update(drop)
                for p in drop:
                    self.prunes_sent += 1
                    self._send(p, _frame(_PRUNE, topic))
        # lazy gossip: advertise recently learned ids (+ always our own
        # topic, so stragglers can complete from the owner no matter how
        # old the message) to D_lazy random peers outside our own topic's
        # mesh; IWANT answers repair their gaps
        window = sorted(
            t
            for t, b in self._learned_at.items()
            if self._beat - b <= self.history or t == self.id
        )[:8192]
        if window:
            targets = self._sample_peers(
                self.D_lazy, excluding=self.mesh.get(self.id, set())
            )
            self.ihave_sent += len(targets)
            frame = _frame(_IHAVE, 0, _topics_payload(window))
            self._send_many(targets, frame)

    # -- aggregation (aggregator.go at-threshold path) -----------------------

    def _maybe_finish(self) -> None:
        if self.final.done() or len(self.sigs) < self.threshold:
            return
        bs = BitSet(self.reg.size())
        agg = None
        for origin, sig in self.sigs.items():
            bs.set(origin, True)
            agg = sig if agg is None else agg.combine(sig)
        self.final.set_result(MultiSignature(bs, agg))

    def values(self) -> dict[str, float]:
        return {
            "sigsKnown": float(len(self.sigs)),
            "sigCheckedCt": float(self.sigs_checked),
            "graftsSent": float(self.grafts_sent),
            "prunesSent": float(self.prunes_sent),
            "ihaveSent": float(self.ihave_sent),
            "iwantSent": float(self.iwant_sent),
        }


async def run_gossipsub(
    n: int,
    threshold: int | None = None,
    timeout: float = 30.0,
    scheme=None,
    **kwargs,
):
    """n-node gossipsub aggregation over the in-process router."""
    from handel_tpu_torch.baselines.gossip import run_gossip

    return await run_gossip(
        n,
        threshold=threshold,
        timeout=timeout,
        scheme=scheme,
        aggregator_cls=GossipSubAggregator,
        **kwargs,
    )
