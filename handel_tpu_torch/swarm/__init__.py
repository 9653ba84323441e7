"""Virtual-node swarm runtime — a copy of handel_tpu/swarm/.

One process multiplexes thousands of Handel identities: cooperative timers
on a shared wheel (core/timeout.py TimerWheel), in-memory packet delivery
between co-resident vnodes with shared-socket UDP across processes
(swarm/router.py), all verification through ONE BatchVerifierService per
process — one session per committee MEMBER, dedup scoped per committee
(swarm/vnode.py) — windowed signature stores retiring completed levels
(core/store.py), and registry residency paged in level-sized chunks
(swarm/pager.py). Entry points: `sim swarm` (sim/__main__.py) and
`run_swarm` (swarm/driver.py).

Like the JAX package's, it runs the fake scheme on a host device
(`HostDevice`) and launches nothing on the card.
"""

from handel_tpu_torch.swarm.driver import SwarmHost, run_swarm
from handel_tpu_torch.swarm.pager import PagedDevice, RegistryPager
from handel_tpu_torch.swarm.router import SwarmNetwork, SwarmRouter
from handel_tpu_torch.swarm.vnode import SWARM_DEDUP_SCOPE, VirtualNode, build_vnode

__all__ = [
    "SWARM_DEDUP_SCOPE",
    "PagedDevice",
    "RegistryPager",
    "SwarmHost",
    "SwarmNetwork",
    "SwarmRouter",
    "VirtualNode",
    "build_vnode",
    "run_swarm",
]
