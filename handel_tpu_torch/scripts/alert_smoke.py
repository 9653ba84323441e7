"""Alerting gate: the SLO burn-rate and incident-plane chaos drill —
counterpart of scripts/alert_smoke.py.

Runs the port's `sim load` open-loop traffic in-process twice with the
alert plane on (handel_tpu_torch/obs/):

1. drill: a forced mid-run region kill. The region-health detector must
   open exactly one incident, its attribution must name the killed region,
   the detection latency must stay under the bound, and the incident must
   close after the recovery.
2. clean control: the same load with no kill. No incident may open:
   `false_positive_rate` must be exactly 0.0.

The reference's last step, a dry run of scripts/bench_check.py over the
drill's report, is a bench gate: it comes with the port's benchmark
(ROADMAP item 10a). The federation runs on host devices, as the
reference's does: nothing here touches the card.

    python -m handel_tpu_torch.scripts.alert_smoke [--artifact-dir DIR]
        [--duration S] [--rate SPS] [--latency-bound-ms MS]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile

from handel_tpu_torch.sim.config import AlertParams, FederationParams, LoadParams
from handel_tpu_torch.sim.load import run_load


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact-dir", default="", help="keep incident_report.json here")
    ap.add_argument("--duration", type=float, default=30.0,
                    help="load window per run in seconds (two runs: drill and control)")
    ap.add_argument("--rate", type=float, default=5.0,
                    help="open-loop arrival rate (sessions/s)")
    ap.add_argument("--latency-bound-ms", type=float, default=3000.0,
                    help="the most a kill may take to open its incident")
    args = ap.parse_args(argv)

    lo = LoadParams(rate_sps=args.rate, duration_s=args.duration, nodes=6, seed=19)
    # window_scale compresses the 1 m / 15 m burn windows to the drill's
    # scale; min_hold and cooldown are short so the close lands in the run
    al = AlertParams(window_scale=0.02, min_hold_s=1.0, cooldown_s=3.0,
                     tick_interval_s=0.25)

    with tempfile.TemporaryDirectory() as tmp:
        d = args.artifact_dir or tmp
        os.makedirs(d, exist_ok=True)

        # -- the drill: a forced region kill ---------------------------------
        fe = FederationParams(kill_region="us-east")
        report = asyncio.run(run_load(lo, fe, d, alert_p=al))
        al_block = report["alerts"]
        assert al_block is not None, "alert plane did not run"
        incidents = al_block["report"]["incidents"]
        kill = report["federation"]["kill"]
        print(
            f"drill: {len(incidents)} incident(s), "
            f"detection {report['detection_latency_ms']:.1f}ms, "
            f"false-positive rate {report['false_positive_rate']}, "
            f"kill at {kill['killed_at_s']}s"
        )
        assert len(incidents) == 1, (
            f"expected exactly one incident, got {len(incidents)}: "
            f"{json.dumps(incidents, indent=1)}"
        )
        inc = incidents[0]
        # the snapshot taken when it opened names the killed region
        attributed = inc["attribution"].get("unhealthy_regions", [])
        assert "us-east" in attributed, (
            f"incident attribution missed the killed region: {attributed}"
        )
        assert 0.0 < report["detection_latency_ms"] <= args.latency_bound_ms, (
            f"detection latency {report['detection_latency_ms']}ms "
            f"outside (0, {args.latency_bound_ms}]"
        )
        # the drill's incident was expected: no false positive
        assert report["false_positive_rate"] == 0.0
        assert inc["state"] == "closed", f"incident never closed: {json.dumps(inc, indent=1)}"
        assert os.path.exists(os.path.join(d, "incident_report.json")), (
            "incident_report.json not written"
        )

        # -- the clean control: the same load, no kill -----------------------
        with tempfile.TemporaryDirectory() as tmp2:
            clean = asyncio.run(run_load(lo, FederationParams(), tmp2, alert_p=al))
        opened = clean["alerts"]["report"]["opened"]
        print(f"control: {opened} incident(s), "
              f"false-positive rate {clean['false_positive_rate']}")
        assert opened == 0, (
            f"clean control opened {opened} incident(s): "
            f"{json.dumps(clean['alerts']['report']['incidents'], indent=1)}"
        )
        assert clean["false_positive_rate"] == 0.0

    print("alert smoke: exactly-one-incident drill + clean control held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
