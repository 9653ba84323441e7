"""Mesh latency plane — the routing policy of handel_tpu/parallel/mesh_plane.py.

A launch group rides one of two shapes: **latency** mode (a small group, a
shallow backlog and an SLO tier entitled to it: the whole-mesh lane) or
**throughput** mode (bulk batches and backlogged queues: the per-card
lanes). `BatchVerifierService._route_mesh` consults `ModePolicy` only when
its plane carries a mesh lane; the port's planes carry none yet, so every
group takes the throughput path. The mesh engine and the latency plane
come with meshes of several cards (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass

from handel_tpu_torch.service.fairness import SloTier

__all__ = ["MODE_LATENCY", "MODE_THROUGHPUT", "ModePolicy"]

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
