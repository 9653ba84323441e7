"""Gossip ("diffuse-everything") aggregation baseline — a copy of
handel_tpu/baselines/gossip.py.

Reference: simul/p2p/aggregator.go:17-276 — every node periodically diffuses
individual signatures it knows; aggregation happens locally once `threshold`
distinct signatures are collected. Two verification modes mirror the
reference: `verify_incoming=True` checks every individual signature as it
arrives (aggregator.go verifyPacket); False defers verification to the final
aggregate (aggregate-then-verify, aggregator.go:206 mode). Connectors:
`full` = diffuse to the entire registry ("N^2", p2p/udp/node.go Diffuse) or
`random-k` = k random peers per round (the gossipsub stand-in).

Packet reuse: gossip rides the same `Packet` wire format with level=255 as
the baseline marker (the reference uses a dedicated setup level 255 in
p2p/libp2p/node.go).

Tracing: with a `recorder` attached the baseline emits
the SAME recv/verify/merge pipeline spans, `net_transit`, send-side flow
links and `threshold_reached` instant as Handel (core/handel.py), so
baseline-vs-handel trace comparisons in sim/trace_cli.py are like-for-like.
"""

from __future__ import annotations

import asyncio
import random
from typing import Sequence

from handel_tpu_torch.core.crypto import Constructor, MultiSignature
from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.identity import Identity, Registry
from handel_tpu_torch.core.net import Network, Packet
from handel_tpu_torch.core.trace import trace_now

GOSSIP_LEVEL = 255


class GossipAggregator:
    """One gossip node (aggregator.go Aggregator)."""

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
        period: float = 0.05,
        connector: str = "full",
        fanout: int = 8,
        verify_incoming: bool = True,
        rand: random.Random | None = None,
        recorder=None,
        trace_tid: int | None = None,
    ):
        self.net = network
        self.reg = registry
        self.id = identity.id
        self.cons = constructor
        self.msg = msg
        self.threshold = threshold
        self.period = period
        self.connector = connector
        self.fanout = fanout
        self.verify_incoming = verify_incoming
        self.rand = rand or random.Random(identity.id)
        # flight recorder (core/trace.py), same span names as Handel
        self.rec = recorder
        self._tid = trace_tid if trace_tid is not None else identity.id
        self._span_seq = 0
        if recorder is not None:
            recorder.name_thread(self._tid, f"gossip-{identity.id}")
        # known individual signatures by origin (aggregator.go sigs map)
        self.sigs: dict[int, object] = {identity.id: own_sig}
        self.final: asyncio.Future = asyncio.get_event_loop().create_future()
        self._task: asyncio.Task | None = None
        self.sigs_checked = 0
        # invalid origins evicted by the threshold-time bisection
        # (aggregate-then-verify mode, _maybe_finish)
        self.sigs_evicted = 0
        network.register_listener(self)

    # -- network in ---------------------------------------------------------

    def new_packet(self, packet: Packet) -> None:
        if packet.level != GOSSIP_LEVEL or packet.origin == self.id:
            return
        if packet.origin in self.sigs:
            return
        rec = self.rec
        tracing = rec is not None and rec.enabled
        t0 = trace_now() if tracing else 0.0
        try:
            sig = self.cons.unmarshal_signature(packet.multisig)
        except Exception:
            return
        if tracing:
            if packet.sent_ts and packet.sent_ts <= t0:
                rec.span(
                    "net_transit",
                    packet.sent_ts,
                    t0,
                    tid=self._tid,
                    cat="net",
                    args={
                        "origin": packet.origin,
                        "level": packet.level,
                        "span": packet.span_id,
                    },
                )
            t1 = trace_now()
            rec.span(
                "recv",
                t0,
                t1,
                tid=self._tid,
                cat="pipeline",
                args={
                    "origin": packet.origin,
                    "level": packet.level,
                    "rts": int(t0 * 1e6),
                    "span": packet.span_id,
                },
            )
            if packet.span_id:
                rec.flow("contrib", packet.span_id, "t", t1, tid=self._tid)
        if self.verify_incoming:
            pk = self.reg.identity(packet.origin).public_key
            self.sigs_checked += 1
            tv = trace_now() if tracing else 0.0
            ok = pk.verify(self.msg, sig)
            if tracing:
                rec.span(
                    "verify",
                    tv,
                    trace_now(),
                    tid=self._tid,
                    cat="pipeline",
                    args={
                        "origin": packet.origin,
                        "level": packet.level,
                        "rts": int(t0 * 1e6),
                        "ok": ok,
                        "span": packet.span_id,
                    },
                )
            if not ok:
                return
        if tracing:
            tm = trace_now()
            self.sigs[packet.origin] = sig
            self._maybe_finish()
            tm2 = trace_now()
            rec.span(
                "merge",
                tm,
                tm2,
                tid=self._tid,
                cat="pipeline",
                args={
                    "origin": packet.origin,
                    "level": packet.level,
                    "rts": int(t0 * 1e6),
                    "span": packet.span_id,
                },
            )
            if packet.span_id:
                rec.flow("contrib", packet.span_id, "f", tm2, tid=self._tid)
            return
        self.sigs[packet.origin] = sig
        self._maybe_finish()

    def _maybe_finish(self) -> None:
        if self.final.done() or len(self.sigs) < self.threshold:
            return
        if not self.verify_incoming:
            # aggregate-then-verify mode: one combined check at threshold.
            # On failure, bisect by origin (models/rlc.py bisect_verify —
            # the binary search the reference leaves as a TODO at
            # aggregator.go:206) and EVICT the culprits, so the poisoned
            # subset is never re-verified wholesale on every later packet
            # (the inherited double-count: sigs_checked grew by one full
            # aggregate check per arrival while the set stayed poisoned).
            from handel_tpu_torch.models.rlc import bisect_verify

            keys = [
                self.reg.identity(i).public_key for i in range(self.reg.size())
            ]

            def check(origins) -> bool:
                self.sigs_checked += 1
                b = BitSet(self.reg.size())
                a = None
                for o in origins:
                    b.set(o, True)
                    s = self.sigs[o]
                    a = s if a is None else a.combine(s)
                return bool(
                    self.cons.aggregate_public_keys(keys, b).verify(
                        self.msg, a
                    )
                )

            verdicts = bisect_verify(
                list(self.sigs), check, lambda o: check([o])
            )
            bad = [o for o, ok in verdicts.items() if not ok]
            for o in bad:
                del self.sigs[o]
                self.sigs_evicted += 1
            if bad and len(self.sigs) < self.threshold:
                return  # keep gossiping with the clean partial set
        # every surviving origin passed a combined or per-origin check (or
        # verify_incoming already vetted it at arrival)
        bs = BitSet(self.reg.size())
        agg = None
        for origin, sig in self.sigs.items():
            bs.set(origin, True)
            agg = sig if agg is None else agg.combine(sig)
        ms = MultiSignature(bs, agg)
        if self.rec is not None:
            self.rec.instant(
                "threshold_reached",
                tid=self._tid,
                cat="protocol",
                args={"card": bs.cardinality(), "threshold": self.threshold},
            )
        self.final.set_result(ms)

    # -- gossip loop --------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.get_event_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task:
            self._task.cancel()

    def _peers(self) -> Sequence[Identity]:
        ids = [
            self.reg.identity(i)
            for i in range(self.reg.size())
            if i != self.id
        ]
        if self.connector == "full":
            return ids
        return self.rand.sample(ids, min(self.fanout, len(ids)))

    async def _loop(self) -> None:
        # keep diffusing after our own threshold is met — peers on sparse
        # overlays may still need our signatures (the reference's aggregator
        # gossips until the simulation stops it); `stop()` cancels the task
        while True:
            # diffuse every known individual signature (aggregator.go Diffuse)
            rec = self.rec
            tracing = rec is not None and rec.enabled
            for origin, sig in list(self.sigs.items()):
                if tracing:
                    self._span_seq += 1
                    sid = (self.id << 40) | self._span_seq
                    t0 = trace_now()
                else:
                    sid = 0
                peers = self._peers()
                self.net.send(
                    peers,
                    Packet(
                        origin=origin,
                        level=GOSSIP_LEVEL,
                        multisig=sig.marshal(),
                        sent_ts=trace_now(),
                        span_id=sid,
                        # forwarding another node's signature is a hop
                        hop=1 if sid and origin != self.id else 0,
                    ),
                )
                if tracing:
                    rec.span(
                        "send",
                        t0,
                        trace_now(),
                        tid=self._tid,
                        cat="pipeline",
                        args={
                            "level": GOSSIP_LEVEL,
                            "card": 1,
                            "peers": len(peers),
                            "span": sid,
                        },
                    )
                    rec.flow("contrib", sid, "s", t0, tid=self._tid)
            self._maybe_finish()
            await asyncio.sleep(self.period)

    def values(self) -> dict[str, float]:
        return {
            "sigsKnown": float(len(self.sigs)),
            "sigCheckedCt": float(self.sigs_checked),
            "sigEvictedCt": float(self.sigs_evicted),
        }


async def run_gossip(
    n: int,
    threshold: int | None = None,
    timeout: float = 20.0,
    scheme=None,
    aggregator_cls: type | None = None,
    **kwargs,
) -> dict[int, MultiSignature]:
    """Run an n-node gossip aggregation over the in-process router.

    `aggregator_cls` selects the node implementation (default
    GossipAggregator; baselines/gossipsub.py passes its mesh variant)."""
    from handel_tpu_torch.core.test_harness import FakeScheme, InProcessNetwork, InProcessRouter

    cls = aggregator_cls or GossipAggregator
    scheme = scheme or FakeScheme()
    threshold = threshold or (n // 2 + 1)
    router = InProcessRouter()
    idents, secrets = [], []
    for i in range(n):
        sk, pk = scheme.keygen(i)
        idents.append(Identity(i, f"gossip-{i}", pk))
        secrets.append(sk)
    from handel_tpu_torch.core.identity import ArrayRegistry

    registry = ArrayRegistry(idents)
    msg = b"gossip baseline msg"
    nodes = []
    for i in range(n):
        net = InProcessNetwork(router, f"gossip-{i}")
        nodes.append(
            cls(
                net,
                registry,
                idents[i],
                scheme.constructor,
                msg,
                secrets[i].sign(msg),
                threshold,
                **kwargs,
            )
        )
    for node in nodes:
        node.start()
    try:
        finals = await asyncio.wait_for(
            asyncio.gather(*(node.final for node in nodes)), timeout
        )
    finally:
        for node in nodes:
            node.stop()
    return dict(zip(range(n), finals))
