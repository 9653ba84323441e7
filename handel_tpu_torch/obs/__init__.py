"""Detection-and-incident plane over the observability surfaces — a copy
of handel_tpu/obs/.

The planes below it emit every signal a verify service needs (reporter
`values()` planes, LogHistogram quantiles, causal traces); `obs/`
interprets them:

- `slo.py`       multi-window error-budget burn-rate evaluation over the
                 tiered SLO targets (service/fairness.py) and the
                 federation goodput/shed planes
- `detect.py`    streaming EWMA + MAD z-score anomaly detectors,
                 attachable to any reporter key or histogram quantile,
                 seeded-deterministic and O(1) memory per series
- `incidents.py` firing rules open/escalate/close Incident objects with
                 a causal-attribution snapshot captured at open time
- `plane.py`     AlertPlane composes the three, ticks from the
                 LifecycleController, exports `handel_alerts_*` /
                 `handel_incidents_*` metrics and the `/alerts` endpoint
- `rollup.py`    hierarchical HostRollup/FleetRollup digests so the
                 fleet-scale plane costs O(hosts), not O(identities):
                 per-host bounded digests ride the monitor Sink as
                 chunked deltas, the master merge feeds the same
                 AlertPlane and exports `handel_fleet_*` + `/fleet`
"""

from handel_tpu_torch.obs.detect import (  # noqa: F401
    Detection,
    DetectorBank,
    EwmaDetector,
    MadDetector,
    counter_rate,
    histogram_quantile_source,
    reporter_key_source,
)
from handel_tpu_torch.obs.incidents import Incident, IncidentLog  # noqa: F401
from handel_tpu_torch.obs.plane import AlertPlane  # noqa: F401
from handel_tpu_torch.obs.rollup import (  # noqa: F401
    FleetRollup,
    HostRollup,
    chunk_delta,
    merge_trace_digests,
    trace_digest,
)
from handel_tpu_torch.obs.slo import BurnRateEvaluator, BurnRule  # noqa: F401
