"""Mesh latency plane: one verify launch over the whole mesh — a copy of
handel_tpu/parallel/mesh_plane.py.

`bn254_plane` (parallel/plane.py) pins one engine a card and the
DevicePlane schedules launch groups least-loaded, so one Miller loop and
final exponentiation run on a single card. This module adds the second
shape: a MESH LANE whose engine spans all K shards for a single launch
(`BN254Device(mesh_devices=K)`, parallel/sharding.py), and the policy that
decides, per launch group, which shape it rides:

  * **latency** mode — the group fits one mesh launch, the backlog is
    shallow, and its best SLO tier is entitled to the mesh (gold by
    default): route to the mesh lane;
  * **throughput** mode — bulk batches and backlogged queues: the per-card
    lanes, where the mesh is worth more as K independent lanes.

The scheduler integration lives in `DevicePlane.pick_mesh` (parallel/
plane.py) and `BatchVerifierService._route_mesh` (batch_verifier.py), which
consult the policy the moment the plane carries a mesh lane; this module
owns the policy, the engine builders and the host engine that models a
mesh launch. Nothing here imports the card engine at module level.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from handel_tpu_torch.service.fairness import SloTier

__all__ = [
    "MODE_LATENCY",
    "MODE_THROUGHPUT",
    "ModePolicy",
    "HostMeshDevice",
    "bn254_mesh_engine",
    "host_mesh_engine",
    "enable_latency_plane",
]

MODE_LATENCY = "latency"
MODE_THROUGHPUT = "throughput"


@dataclass(frozen=True)
class ModePolicy:
    """When does a launch group ride the whole-mesh latency lane?

    `small_batch_max` caps latency-mode group size (the mesh engine's own
    batch_size also caps it — a group must fit ONE mesh launch).
    `max_queue_depth` is the backlog bound: a queue deeper than this keeps
    groups on the per-lane throughput path, where K independent lanes beat
    one fast lane. `latency_tiers` names the SLO tiers (service/fairness.py
    TIERS) entitled to the mesh: gold-tier small batches go latency, bronze
    bulk stays per-lane.
    """

    small_batch_max: int = 64
    max_queue_depth: int = 128
    latency_tiers: tuple = ("gold",)

    def pick_mode(
        self,
        n_items: int,
        queue_depth: int,
        tier,
        mesh_batch: int,
    ) -> str:
        if n_items > min(self.small_batch_max, mesh_batch):
            return MODE_THROUGHPUT
        if queue_depth > self.max_queue_depth:
            return MODE_THROUGHPUT
        name = tier.name if isinstance(tier, SloTier) else str(tier)
        if name not in self.latency_tiers:
            return MODE_THROUGHPUT
        return MODE_LATENCY


class HostMeshDevice:
    """Host-math engine modeling ONE whole-mesh launch (the service's CPU
    and bench shape).

    The card engine is `BN254Device(mesh_devices=K)`. This one keeps the
    real verdict math (the scheme constructor's batch_verify) and SIMULATES
    the wall, as service/driver.py `HostDevice` does, but models the
    parallelism inside a launch: each candidate costs `per_candidate_ms`,
    the candidates shard over `devices` concurrent worker threads (the
    measured wall is the slowest worker's, contention included), and
    `collective_ms` is the serial gather-and-combine share. So a batch-n
    launch walls about per_candidate_ms * ceil(n/K) + collective_ms, and
    `devices=1` is the single-lane baseline with identical code.
    """

    def __init__(
        self,
        constructor,
        batch_size: int = 64,
        devices: int = 8,
        per_candidate_ms: float = 1.0,
        collective_ms: float = 0.5,
    ):
        self.constructor = constructor
        self.batch_size = batch_size
        self.mesh_devices = max(1, devices)
        self.per_candidate_ms = per_candidate_ms
        self.collective_ms = collective_ms
        self.dispatched = 0
        self.mesh_launches = 0
        self.mesh_candidates = 0
        self._pool = (
            ThreadPoolExecutor(max_workers=self.mesh_devices)
            if self.mesh_devices > 1
            else None
        )
        # epoch rotation (lifecycle/epoch.py, HostDevice's stubs): no
        # resident bank to flip, but the stage -> quiesce -> activate
        # choreography reaches mesh lanes too
        self.epoch = 0
        self._staged = None
        self.registry_stagings = 0
        self.registry_staged_ms = 0.0

    def stage_registry(self, registry_pubkeys, build_prefix: bool = True) -> int:
        self._staged = registry_pubkeys
        self.registry_stagings += 1
        return len(registry_pubkeys)

    def activate_staged(self) -> int:
        if self._staged is None:
            raise RuntimeError("no staged registry: call stage_registry first")
        self._staged = None
        self.epoch += 1
        return self.epoch

    def _verify_shard(self, items, idxs):
        verdicts = {}
        for i in idxs:
            msg, pubkeys, bitset, sig = items[i]
            ok = self.constructor.batch_verify(msg, pubkeys, [(bitset, sig)])
            verdicts[i] = bool(ok[0])
        if self.per_candidate_ms > 0:
            time.sleep(self.per_candidate_ms * len(idxs) / 1000.0)
        return verdicts

    def dispatch_multi(self, items):
        k = self.mesh_devices
        shards = [list(range(i, len(items), k)) for i in range(k)]
        shards = [s for s in shards if s]
        if self._pool is None or len(shards) <= 1:
            merged = self._verify_shard(items, list(range(len(items))))
        else:
            futs = [self._pool.submit(self._verify_shard, items, s) for s in shards]
            merged = {}
            for f in futs:
                merged.update(f.result())
        if self.collective_ms > 0:
            time.sleep(self.collective_ms / 1000.0)
        self.dispatched += 1
        self.mesh_launches += 1
        self.mesh_candidates += len(items)
        return [merged[i] for i in range(len(items))]

    def fetch(self, handle):
        return handle


def host_mesh_engine(
    constructor,
    devices: int = 8,
    batch_size: int = 64,
    per_candidate_ms: float = 1.0,
    collective_ms: float = 0.5,
) -> HostMeshDevice:
    """The host mesh engine (see HostMeshDevice)."""
    return HostMeshDevice(
        constructor,
        batch_size=batch_size,
        devices=devices,
        per_candidate_ms=per_candidate_ms,
        collective_ms=collective_ms,
    )


def bn254_mesh_engine(
    registry_pubkeys,
    devices: int,
    batch_size: int = 8,
    curves=None,
    warmup: bool = False,
    mesh=None,
):
    """The card's whole-mesh latency engine: ONE BN254Device spanning K
    shards (`mesh_devices=K`, the staged sharded pipeline of
    models/bn254_torch.py), against `bn254_plane`'s one engine a card.
    `mesh` places the shards explicitly (parallel/sharding.py `make_mesh`,
    e.g. two shards on one card); without it they are cards 0..K-1, and
    fewer visible cards raise, naming the count. `curves` (default: cios, on the
    mesh's first device) must be on the first shard's device. Warmup
    is off by default, as for `bn254_plane`."""
    from handel_tpu_torch.models.bn254_torch import BN254Device
    from handel_tpu_torch.parallel.sharding import make_mesh

    if mesh is None:
        mesh = make_mesh(devices)
    elif mesh.size != devices:
        raise ValueError(f"mesh of {mesh.size} shards for devices={devices}")
    eng = BN254Device(
        registry_pubkeys,
        batch_size=batch_size,
        curves=curves,
        mesh_devices=devices,
        mesh=mesh,
    )
    if warmup:
        eng.warmup()
    return eng


def enable_latency_plane(service, engine, policy: ModePolicy | None = None,
                         breaker=None):
    """Attach `engine` as the service's mesh lane and arm dual-mode
    scheduling (BatchVerifierService._route_mesh consults the policy the
    moment a mesh lane exists). On a running service the lane's
    dispatcher/fetcher pair spawns immediately; before start() it joins
    the plane and wires with the rest. Returns the new lane."""
    if policy is not None:
        service.mode_policy = policy
    return service.attach_lane(engine, breaker, mesh=True)
