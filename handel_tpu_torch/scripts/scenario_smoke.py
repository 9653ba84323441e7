"""Scenario-engine gate: the composed WAN drill — counterpart of
scripts/scenario_smoke.py.

Runs one in-process `sim scenario` round of the port with every axis on at
once: a 32-node committee over the fast 3-region planet, about 10% of it
departing mid-round on the seeded membership schedule, a join admitted
through the epoch path, and completion gated on pareto-distributed stake
instead of a count. Then asserts the invariants its report carries:

- the weighted threshold was reached (achieved stake >= the gate)
- every survivor marked every churner departed (re-levelling happened)
- the join advanced the epoch at least once (stage, quiesce, flip)
- the trace's critical path attributes at least one WAN hop to a region
  pair

The reference's last step, a regression gate of the report against the
committed capture history (scripts/bench_check.py), is a bench gate: it
comes with the port's benchmark (ROADMAP item 10a). The scenario runs the
fake scheme on the host, as the reference's does: nothing here touches the
card.

    python -m handel_tpu_torch.scripts.scenario_smoke [--artifact-dir DIR] [--nodes N]
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import tempfile

from handel_tpu_torch.scenario import run_scenario
from handel_tpu_torch.sim.confgen import scenario_geo_weighted


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact-dir", default="",
                    help="keep scenario_report.json + trace here")
    ap.add_argument("--nodes", type=int, default=32,
                    help="committee size (3-region fast planet, ~10%% churn)")
    args = ap.parse_args(argv)

    cfg = scenario_geo_weighted(args.nodes)
    # the fast planet keeps the WAN delays at milliseconds: a quick drill
    cfg.scenario.planet = "planet-3region-fast"
    cfg.scenario.jitter_ms = 1.0
    cfg.scenario.joins = 1

    with tempfile.TemporaryDirectory() as tmp:
        d = args.artifact_dir or tmp
        os.makedirs(d, exist_ok=True)
        report = asyncio.run(run_scenario(cfg, d))

        s = report["scenario"]
        print(
            f"scenario: {s['nodes']} nodes / {len(s['regions'])} regions, "
            f"{s['churners']} departed, {s['joins']} joined "
            f"({s['epochs_advanced']} epoch advance), stake "
            f"{s['achieved_weight']:.2f}/{s['weight_threshold']:.2f}, "
            f"ttt {report['geo_weighted_ttt_s']}s"
        )
        for name, ok in report["checks"].items():
            print(f"  check {name}: {'ok' if ok else 'FAILED'}")
        assert report["checks"]["threshold_reached"], (
            f"weighted threshold missed: {s['achieved_weight']} < {s['weight_threshold']}"
        )
        assert report["checks"]["departures_marked"], (
            f"churners {s['departed_ids']} not marked departed everywhere"
        )
        assert report["checks"]["epoch_advanced"], "join did not advance the epoch"
        assert report["checks"]["region_attributed"], (
            "critical path attributed no WAN hop to a region pair"
        )
        assert s["region_hops"], "trace carried no region-tagged hops"
        assert report["ok"], f"scenario checks failed: {report['checks']}"
        assert os.path.exists(os.path.join(d, "scenario_report.json"))

    print("scenario smoke: all WAN scenario invariants held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
