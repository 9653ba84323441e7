"""Virtual node: one Handel identity on the shared swarm event loop — a copy
of handel_tpu/swarm/vnode.py.

The per-node cost model is inverted versus the service plane (service/). A service session is one COMMITTEE sharing the
verify plane; a swarm vnode is one committee MEMBER — the session id is the
member's global id, so fairness/admission isolate members, while the dedup
verdict cache uses one shared `dedup_scope` for the whole committee (every
member sees the same winning aggregates; 65k separate scopes would re-verify
identical bytes 65k times — parallel/batch_verifier.py `verify`).

What a vnode deliberately does NOT own:

- no asyncio timer tasks — level starts ride `WheelTimeout` and the gossip
  round is a `TimerWheel` periodic callback (core/timeout.py), so timer
  state is O(1) per vnode on ONE wheel task;
- no per-node Random — `Config.rand`'s default is a full Mersenne state
  (~2.5 KB); with shuffling disabled it is never drawn from, so every vnode
  shares one;
- no peer scorer — the swarm models honest committees; a scorer dict per
  vnode is per-peer state the memory budget can't carry;
- no candidate-list copies — `disable_shuffling=True` keeps the
  partitioner's O(1) `RegistrySlice` views (core/handel.py create_levels);
- no per-level eager bitsets — `WindowedSignatureStore` retires completed
  levels (core/store.py).
"""

from __future__ import annotations

import time

from handel_tpu_torch.core.config import Config
from handel_tpu_torch.core.handel import Handel
from handel_tpu_torch.core.store import WindowedSignatureStore
from handel_tpu_torch.core.timeout import TimerWheel, WheelTimeout
from handel_tpu_torch.swarm.router import SwarmNetwork, SwarmRouter

#: shared committee-wide dedup scope (one committee per swarm run)
SWARM_DEDUP_SCOPE = "swarm"


def _no_scorer(handel) -> None:
    """`Config.new_scorer` for an honest vnode: no peer accounting."""
    return None


class VirtualNode:
    """One Handel instance plus its swarm wiring and completion stamp."""

    __slots__ = ("id", "handel", "started_at", "done_ts", "_gossip")

    def __init__(self, ident, handel: Handel):
        self.id = ident.id
        self.handel = handel
        self.started_at = 0.0
        self.done_ts = 0.0  # monotonic stamp of first observed threshold
        self._gossip = None  # wheel handle for the periodic update

    def start(self, wheel: TimerWheel, phase_s: float) -> None:
        self.started_at = time.monotonic()
        self.handel.start(periodic=False)
        self._gossip = wheel.schedule_periodic(
            self.handel.c.update_period, self.handel.periodic_update,
            phase_s=phase_s,
        )

    def stop(self) -> None:
        if self._gossip is not None:
            self._gossip.cancel()
            self._gossip = None
        self.handel.stop()

    @property
    def reached_threshold(self) -> bool:
        return self.handel.best is not None

    def time_to_threshold(self) -> float:
        """Seconds from start to the driver's first observation of this
        vnode's threshold signature (scan-period granularity; the trace's
        `threshold_reached` instants carry the exact stamps)."""
        if not self.done_ts:
            return 0.0
        return self.done_ts - self.started_at


def build_vnode(
    ident,
    secret,
    registry,
    constructor,
    msg: bytes,
    router: SwarmRouter,
    wheel: TimerWheel,
    verifier_service,
    *,
    threshold: int,
    update_period: float,
    level_timeout: float,
    shared_rand,
    fast_path: int = 3,
    batch_size: int = 64,
    max_pending: int = 256,
    recorder=None,
    logger=None,
) -> VirtualNode:
    """Wire one identity into the swarm runtime (module docstring for why
    each knob is what it is)."""
    cfg = Config(
        contributions=threshold,
        update_period=update_period,
        level_timeout=level_timeout,
        fast_path=fast_path,
        disable_shuffling=True,
        new_scorer=_no_scorer,
        rand=shared_rand,
        new_store=WindowedSignatureStore,
        new_timeout=WheelTimeout.factory(wheel, level_timeout),
        session=str(ident.id),
        verifier=verifier_service.session_verifier(
            str(ident.id), dedup_scope=SWARM_DEDUP_SCOPE
        ),
        batch_size=batch_size,
        max_pending=max_pending,
        recorder=recorder,
    )
    if logger is not None:
        cfg.logger = logger
    net = SwarmNetwork(router, ident.id)
    own_sig = secret.sign(msg)
    h = Handel(net, registry, ident, constructor, msg, own_sig, cfg)
    return VirtualNode(ident, h)
