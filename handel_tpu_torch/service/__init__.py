"""Multi-tenant aggregation service: many committees, one device plane — the
port of handel_tpu/service/.

A `SessionManager` (session.py) owns session lifecycle (spawn → running →
threshold-reached → expire/evict) behind a bounded concurrent-session cap;
every session's candidates coalesce into the shared verifier's launches
under the deficit-round-robin `TenantQueue` (fairness.py); the per-tenant
state — dedup verdicts, peer penalties, queue bounds — is keyed by session
id, so evicting a tenant drops its footprint wholesale. driver.py runs the
sessions in one process (`MultiSessionCluster`) or over worker processes
(`run_service`, worker.py), and adapts host schemes to the device contract
(`HostDevice`). federation.py fronts several regions' planes with one
`FrontDoor` (`Federation`, `RegionPlane`): health, spill-over and region
loss. `SloTier` (fairness.py) is the port's own export: the reference
keeps it unexported.
"""

from handel_tpu_torch.service.fairness import SloTier, TenantQueue
from handel_tpu_torch.service.federation import (
    Federation,
    FrontDoor,
    RegionDead,
    RegionPlane,
    RegionShedding,
)
from handel_tpu_torch.service.session import (
    STATE_DONE,
    STATE_EVICTED,
    STATE_EXPIRED,
    STATE_RUNNING,
    STATE_SPAWNED,
    AdmissionRefused,
    Session,
    SessionManager,
)

__all__ = [
    "AdmissionRefused",
    "Federation",
    "FrontDoor",
    "RegionDead",
    "RegionPlane",
    "RegionShedding",
    "Session",
    "SessionManager",
    "SloTier",
    "TenantQueue",
    "STATE_SPAWNED",
    "STATE_RUNNING",
    "STATE_DONE",
    "STATE_EXPIRED",
    "STATE_EVICTED",
]
