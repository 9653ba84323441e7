"""The aggregation service plane — the part of handel_tpu/service/ that the
shared batch verifier runs on: the deficit-round-robin tenant queue
(fairness.py) and the host-math device engine (driver.py `HostDevice`).

Sessions, the multi-session cluster and the `serve` driver are not ported
yet (ROADMAP).
"""

from handel_tpu_torch.service.fairness import SloTier, TenantQueue

__all__ = ["SloTier", "TenantQueue"]
