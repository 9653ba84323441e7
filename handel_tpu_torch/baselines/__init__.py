"""Baseline comparison protocols — a copy of handel_tpu/baselines/.

Reference: simul/p2p/ — a gossip aggregator (aggregator.go:17-276) over two
transports: full-mesh "N^2" UDP diffusion (p2p/udp/node.go:17-91) and libp2p
gossipsub (p2p/libp2p/node.go:89-434). These exist only to produce the
comparison curves against Handel (BASELINE.md rows "Baseline N^2 gossip" and
"Baseline libp2p"). Here the gossip aggregator runs over the same Network
interface as the protocol (in-process router or UDP sockets), and the
gossipsub slot implements the router's actual v1.0 semantics (per-topic
meshes, GRAFT/PRUNE, IHAVE/IWANT) on that same interface — no libp2p
dependency needed. Both verify each signature with the scheme's host
`verify`, as the JAX package's do, and launch nothing on the card.
"""

from handel_tpu_torch.baselines.gossip import GossipAggregator, run_gossip
from handel_tpu_torch.baselines.gossipsub import GossipSubAggregator, run_gossipsub

__all__ = [
    "GossipAggregator",
    "run_gossip",
    "GossipSubAggregator",
    "run_gossipsub",
]
