"""In-process multi-node harness — a copy of handel_tpu/core/test_harness.py.

Reference: test.go:15-251 — the `Test` struct building N fully wired Handel
instances over an in-memory network (`TestNetwork`, test.go:226-251), with
offline-node injection (:79-90), threshold control, and a complete-success
barrier (`WaitCompleteSuccess`).

The "network" routes packets between nodes sharing one asyncio event loop;
every packet is encoded and decoded on the way, so the wire path runs. With
`BN254TorchScheme` the cluster drives the port's device engine: each node's
verify launches and merges reach the card.

Shared verifier: nodes reach one `BatchVerifierService`
(parallel/batch_verifier.py) through `config_factory`, with
`cfg.verifier = service.verify`; `verifier_service=` holds the service on
the cluster, where the reference's metrics read it. A factory replaces the
harness's defaults, so it sets `new_timeout = InfiniteTimeout` and
`rand = random.Random(seed + i)` itself when the round should keep the
shape of a default one.

Faults and observability: `loss_rate` drops routed packets, `chaos` wraps
each node's network in a seeded `ChaosNetwork`, `adversaries` seats
byzantine roles (sim/adversary.py), `recorder` shares one flight recorder
(core/trace.py) across the nodes and `metrics_port` serves the cluster's
/metrics (core/metrics.py), and `geo` wraps each node's network in a
`GeoNetwork` (network/geo.py: region-pair WAN delay, chaos composed on top)
and tags its spans with its region. Stake weights reach the nodes through
`config_factory` (`cfg.weights`); a churner role leaves after
`churn_after_s` and its departure is broadcast to every co-resident node
(`Handel.mark_departed`).
"""

from __future__ import annotations

import asyncio
import random
from typing import Callable, Sequence

from handel_tpu_torch.core.config import Config
from handel_tpu_torch.core.crypto import Constructor, MultiSignature
from handel_tpu_torch.core.handel import Handel
from handel_tpu_torch.core.identity import ArrayRegistry, Identity
from handel_tpu_torch.core.net import Listener, Packet
from handel_tpu_torch.core.timeout import InfiniteTimeout
from handel_tpu_torch.models.fake import FakeScheme
from handel_tpu_torch.network.chaos import ChaosConfig, ChaosNetwork
from handel_tpu_torch.network.geo import GeoConfig, GeoNetwork

__all__ = [
    "FakeScheme", "InProcessNetwork", "InProcessRouter", "LocalCluster", "run_cluster",
]


class InProcessRouter:
    """Address -> listener routing table shared by all in-process networks."""

    def __init__(self, loss_rate: float = 0.0, rand: random.Random | None = None):
        self.listeners: dict[str, list[Listener]] = {}
        self.loss_rate = loss_rate
        self.rand = rand or random.Random(0)
        self.sent_packets = 0

    def route(self, identities: Sequence[Identity], packet: Packet) -> None:
        loop = asyncio.get_running_loop()
        wire = packet.encode()
        for ident in identities:
            if self.loss_rate and self.rand.random() < self.loss_rate:
                continue
            for lst in self.listeners.get(ident.address, []):
                self.sent_packets += 1
                # deliver asynchronously, like a real datagram (test.go:242-250)
                loop.call_soon(lst.new_packet, Packet.decode(wire))

    def values(self) -> dict[str, float]:
        """Reporter surface: the cluster-wide transport plane (the udp/tcp
        per-node counters' in-process analog, for the metrics registry)."""
        return {"sentPackets": float(self.sent_packets)}


class InProcessNetwork:
    """Per-node Network bound to a shared router (test.go:226-251)."""

    def __init__(self, router: InProcessRouter, address: str):
        self.router = router
        self.address = address

    def send(self, identities: Sequence[Identity], packet: Packet) -> None:
        self.router.route(identities, packet)

    def register_listener(self, listener: Listener) -> None:
        self.router.listeners.setdefault(self.address, []).append(listener)


class LocalCluster:
    """N wired Handel instances over the in-process network (test.go:15-222)."""

    def __init__(
        self,
        n: int,
        scheme=None,
        threshold: int | None = None,
        offline: Sequence[int] = (),
        msg: bytes = b"hello world",
        config_factory: Callable[[int], Config] | None = None,
        seed: int = 1,
        loss_rate: float = 0.0,
        chaos: ChaosConfig | None = None,
        geo: GeoConfig | None = None,
        adversaries: dict[int, str] | None = None,
        recorder=None,
        metrics_port: int | None = None,
        verifier_service=None,
        churn_after_s: float = 0.5,
    ):
        self.n = n
        self.scheme = scheme or FakeScheme()
        self.msg = msg
        self.offline = set(offline)
        # byzantine roles (sim/adversary.py): node id -> role name. These
        # nodes run — adversarially — so the honest cohort must converge
        # around them, not without them.
        self.roles = dict(adversaries or {})
        self.router = InProcessRouter(
            loss_rate=loss_rate, rand=random.Random(seed)
        )
        cons: Constructor = self.scheme.constructor

        secrets, idents = [], []
        for i in range(n):
            sk, pk = self.scheme.keygen(i)
            secrets.append(sk)
            idents.append(Identity(i, f"inproc-{i}", pk))
        self.registry = ArrayRegistry(idents)

        self.handels: dict[int, Handel] = {}
        self.adversaries: dict[int, Handel] = {}
        # geo delays are not failures, but they do defer deliveries past
        # the no-timeout harness's patience — keep real timeouts on
        has_byzantine = bool(self.offline or self.roles or chaos or geo)
        for i in range(n):
            if i in self.offline:
                continue  # offline nodes are simply never built (test.go:105-113)
            cfg = config_factory(i) if config_factory else Config()
            if recorder is not None:
                # shared flight recorder (core/trace.py): all in-process
                # nodes record into one ring, tid = node id
                cfg.recorder = recorder
            if threshold is not None:
                cfg.contributions = threshold
            if cfg.rand is None or config_factory is None:
                cfg.rand = random.Random(seed + i)
            if not has_byzantine and config_factory is None:
                # no failures -> no timeouts, so stalls are real bugs
                # (handel_test.go:99-101, 442-455)
                cfg.new_timeout = InfiniteTimeout
            net = InProcessNetwork(self.router, f"inproc-{i}")
            if geo is not None:
                # geo-latency planet model (network/geo.py): region-pair
                # WAN delay, chaos faults composed on top when given
                net = GeoNetwork(
                    net,
                    geo.for_node(i),
                    chaos=chaos.for_node(i)
                    if chaos is not None and chaos.any()
                    else None,
                )
                if not cfg.region:
                    cfg.region = geo.region_of(i)
            elif chaos is not None and chaos.any():
                net = ChaosNetwork(net, chaos.for_node(i))
            if i in self.roles:
                from handel_tpu_torch.sim.adversary import build_adversary

                self.adversaries[i] = build_adversary(
                    self.roles[i],
                    net,
                    self.registry,
                    idents[i],
                    cons,
                    self.msg,
                    secrets[i],
                    cfg,
                    leave_after_s=churn_after_s,
                )
                continue
            own_sig = secrets[i].sign(self.msg)
            self.handels[i] = Handel(
                net, self.registry, idents[i], cons, self.msg, own_sig, cfg
            )
        self.threshold = next(iter(self.handels.values())).threshold
        self.verifier_service = verifier_service

        # churn (sim/adversary.py Churner): a departing node broadcasts
        # Handel.mark_departed to every co-resident peer, so survivors
        # re-level and re-evaluate threshold reachability immediately
        churners = [
            a for a in self.adversaries.values()
            if getattr(a, "role", None) == "churner"
        ]
        if churners:
            peers = list(self.handels.values()) + list(
                self.adversaries.values()
            )

            def _on_depart(departed_id: int, _peers=peers) -> None:
                for p in _peers:
                    md = getattr(p, "mark_departed", None)
                    if md is not None:
                        md(departed_id)

            for c in churners:
                c.on_depart = _on_depart

        # live telemetry (core/metrics.py): one registry + HTTP endpoint for
        # the whole in-process cluster, every node's planes under a `node`
        # label. metrics_port=None = fully off.
        self.metrics = None
        self.metrics_server = None
        if metrics_port is not None:
            from handel_tpu_torch.core.metrics import MetricsRegistry, MetricsServer

            reg = MetricsRegistry()
            for i, h in self.handels.items():
                lbl = {"node": str(i)}
                reg.register_values("sigs", h, labels=lbl)
                reg.register_histograms("sigs", h, labels=lbl)
                reg.register_values("penalty", h.scorer, labels=lbl)
            reg.register_values("net", self.router)
            if verifier_service is not None:
                reg.register_values("device_verifier", verifier_service)
            self._started = False
            reg.add_readiness("cluster_started", lambda: self._started)
            reg.add_readiness(
                "breaker_closed",
                lambda: (
                    self.verifier_service is None
                    or self.verifier_service.breaker.state != "open"
                ),
            )
            self.metrics = reg
            self.metrics_server = MetricsServer(reg, port=metrics_port).start()

    def start(self) -> None:
        for h in self.handels.values():
            h.start()
        for a in self.adversaries.values():
            a.start()
        if self.metrics is not None:
            self._started = True

    def stop(self) -> None:
        for h in self.handels.values():
            h.stop()
        for a in self.adversaries.values():
            a.stop()
        if self.metrics_server is not None:
            self.metrics_server.stop()

    def _raise_if_a_node_died(self) -> None:
        """Re-raise the error of a node's processing or gossip task that
        ended with one (a failed merge, say): the node is dead, and waiting
        on its final signature would only run into the timeout."""
        for h in self.handels.values():
            for task in (h.proc._task, h._periodic_task):
                if task is not None and task.done() and not task.cancelled():
                    err = task.exception()
                    if err is not None:
                        raise err

    async def wait_complete_success(
        self, timeout: float = 10.0, poll_s: float = 0.25
    ) -> dict[int, MultiSignature]:
        """Wait until every online node emitted a final signature >= threshold
        (test.go WaitCompleteSuccess). Raises TimeoutError past `timeout`,
        and a node task's own error as soon as one ends with it."""

        async def one(h: Handel) -> MultiSignature:
            return await h.final_signatures.get()

        done = asyncio.ensure_future(
            asyncio.gather(*(one(h) for h in self.handels.values()))
        )
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        try:
            while not done.done():
                self._raise_if_a_node_died()
                left = deadline - loop.time()
                if left <= 0:
                    raise TimeoutError(f"no complete success within {timeout} s")
                await asyncio.wait([done], timeout=min(poll_s, left))
            return dict(zip(self.handels.keys(), done.result()))
        finally:
            # a cancelled gather ends with CancelledError set as its
            # exception: retrieve it, or the loop logs it as never retrieved
            done.add_done_callback(lambda f: f.cancelled() or f.exception())
            done.cancel()


async def run_cluster(
    n: int, timeout: float = 10.0, **kwargs
) -> dict[int, MultiSignature]:
    """Build, run to complete success, and tear down a cluster."""
    cluster = LocalCluster(n, **kwargs)
    cluster.start()
    try:
        return await cluster.wait_complete_success(timeout)
    finally:
        cluster.stop()
