"""Lifecycle gate: the soak drill — counterpart of scripts/soak_smoke.py.

Runs the port's `sim soak` service in-process: sustained tiered sessions
on a multi-lane host plane with a mid-run epoch registry rotation and a
forced lane-0 breaker loss, then asserts the lifecycle invariants its
report carries, through the same predicates the report was stamped with
(sim/report_checks.py SOAK_CHECKS):

- no dropped work: every spawned session reached a verdict, none by
  expiry, across both the swap and the lane loss
- the epoch advanced exactly once (stage, quiesce, flip)
- the swap hid between launches: neither the gate-closed stall nor the
  launch gap around the flip exceeded the steady cadence bound
- the autoscaler replaced the broken lane, and each tenant's p99 stayed
  inside its SLO tier's target

The reference's last step, a regression gate of the report against the
soak history (scripts/bench_check.py), is a bench gate: it comes with the
port's benchmark (ROADMAP item 10a). The soak runs on host devices, as the
reference's does: nothing here touches the card.

    python -m handel_tpu_torch.scripts.soak_smoke [--artifact-dir DIR] [--duration S]
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import tempfile

from handel_tpu_torch.sim.config import SoakParams
from handel_tpu_torch.sim.report_checks import SOAK_CHECKS, assert_checks
from handel_tpu_torch.sim.soak import run_soak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact-dir", default="", help="keep soak_report.json here")
    ap.add_argument("--duration", type=float, default=90.0,
                    help="load window in seconds")
    args = ap.parse_args(argv)

    p = SoakParams(duration_s=args.duration)
    with tempfile.TemporaryDirectory() as tmp:
        d = args.artifact_dir or tmp
        os.makedirs(d, exist_ok=True)
        report = asyncio.run(run_soak(p, d))

        soak = report["soak"]
        print(
            f"soak: {soak['completed']} sessions over {soak['wall_s']}s, "
            f"epoch swap stall {report['epoch_swap_stall_ms']}ms "
            f"(bound {soak['swap_gap_bound_ms']}ms), "
            f"p99 {report['soak_p99_s']}s, shed {report['shed_rate']}"
        )
        for name, ok in report["checks"].items():
            print(f"  check {name}: {'ok' if ok else 'FAILED'}")
        # the predicates the report's `ok` was stamped with, evaluated
        # again from the report: the smoke and the artifact assert the same
        assert_checks(report, SOAK_CHECKS)
        assert report["ok"], f"soak checks failed: {report['checks']}"
        assert os.path.exists(os.path.join(d, "soak_report.json"))

    print("soak smoke: all lifecycle invariants held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
