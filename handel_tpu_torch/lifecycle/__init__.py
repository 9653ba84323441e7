"""Lifecycle control plane — a copy of handel_tpu/lifecycle/.

The service layers below this package are deliberately static: the registry
is committed once (models/bn254_torch.py), the verify plane is a fixed K
lanes (parallel/plane.py), admission is a flat per-tenant bound
(service/fairness.py). This package closes the loop over all of them so
the service "serves heavy traffic and never restarts":

- `EpochManager` (epoch.py) — double-buffered validator-set rotation:
  stage the next registry bank on every lane engine off the critical path,
  quiesce the plane between launches, pointer-flip, bump the epoch that
  versions sessions, dedup keys and trace spans. Zero dropped futures.
- `LaneAutoscaler` (autoscaler.py) — verify-plane elasticity on
  queue-depth and launch-fill signals, and replacement (not degradation)
  of breaker-open lanes.
- `CriticalPathAutotuner` (autotune.py) — feeds the causal tracer's stage
  attribution (sim/trace_cli.py trace_report.json) back into the
  collector window / in-flight window each control interval.
- `LifecycleController` (controller.py) — the periodic control loop tying
  the three together, with one merged telemetry surface.

The soak harness (sim/soak.py, `sim soak`) tests the whole plane, as the
reference's does.
"""

from handel_tpu_torch.lifecycle.autoscaler import LaneAutoscaler
from handel_tpu_torch.lifecycle.autotune import CriticalPathAutotuner
from handel_tpu_torch.lifecycle.controller import LifecycleController
from handel_tpu_torch.lifecycle.epoch import EpochManager

__all__ = [
    "CriticalPathAutotuner",
    "EpochManager",
    "LaneAutoscaler",
    "LifecycleController",
]
