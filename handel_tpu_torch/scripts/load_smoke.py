"""Robustness gate: the geo-federation region-kill drill — counterpart of
scripts/load_smoke.py.

Runs the port's `sim load` open-loop traffic in-process: a seeded Poisson
arrival clock against a 3-region federation (service/federation.py) with a
forced mid-run region kill and recovery through the epoch path. Then
asserts the federation invariants its report carries, through the same
predicates the report was stamped with (sim/report_checks.py
FEDERATION_CHECKS):

- no dropped work: every arrival reached an attributed outcome (completed,
  shed, failed or expired) across the kill, the spill-over and the
  recovery
- the gold tier's open-loop arrival-to-verdict p99 stayed inside its SLO
  target with a whole region gone for a third of the run
- shed stayed under the configured ceiling
- the kill drill ran end to end: the front door saw the death, arrivals
  spilled to the surviving regions, and the revived region rejoined
  through a federation-wide epoch rotation and completed work again

The reference's last step, a regression gate of the report against the
federation history (scripts/bench_check.py), is a bench gate: it comes
with the port's benchmark (ROADMAP item 10a). The federation runs on host
devices, as the reference's does: nothing here touches the card.

    python -m handel_tpu_torch.scripts.load_smoke [--artifact-dir DIR]
        [--duration S] [--rate SPS]
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import tempfile

from handel_tpu_torch.sim.config import FederationParams, LoadParams
from handel_tpu_torch.sim.load import run_load
from handel_tpu_torch.sim.report_checks import FEDERATION_CHECKS, assert_checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact-dir", default="",
                    help="keep federation_report.json here")
    ap.add_argument("--duration", type=float, default=45.0,
                    help="load window in seconds")
    ap.add_argument("--rate", type=float, default=5.0,
                    help="open-loop arrival rate (sessions/s)")
    args = ap.parse_args(argv)

    lo = LoadParams(rate_sps=args.rate, duration_s=args.duration, nodes=6, seed=18)
    fe = FederationParams(kill_region="us-east")
    with tempfile.TemporaryDirectory() as tmp:
        d = args.artifact_dir or tmp
        os.makedirs(d, exist_ok=True)
        report = asyncio.run(run_load(lo, fe, d))

        fed = report["federation"]
        kill = fed["kill"]
        print(
            f"load: {fed['completed']}/{fed['arrivals']} arrivals over "
            f"{fed['wall_s']}s, p99 {report['open_loop_p99_s']:.3f}s, "
            f"spillovers {fed['spillovers']}, shed {report['shed_rate']}, "
            f"kill->detect {kill['unhealthy_detected_s'] - kill['killed_at_s']:.2f}s, "
            f"recovery {report['region_recovery_s']}s "
            f"({kill['post_recovery_completed']} post-recovery completions)"
        )
        for name, ok in report["checks"].items():
            print(f"  check {name}: {'ok' if ok else 'FAILED'}")
        # the predicates the report's `ok` was stamped with, evaluated
        # again from the report: the smoke and the artifact assert the same
        assert_checks(report, FEDERATION_CHECKS)
        assert report["ok"], f"federation checks failed: {report['checks']}"
        # the kill must have hit a live plane, not an idle region
        assert kill is not None and kill["killed_at_s"] is not None
        assert os.path.exists(os.path.join(d, "federation_report.json"))

    print("load smoke: all federation invariants held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
