"""Roll-up gate: O(hosts) fleet observability — counterpart of
scripts/rollup_smoke.py.

Runs the port's `sim swarm` orchestrator over several processes with the
hierarchical roll-up plane on (handel_tpu_torch/obs/rollup.py), and asserts
the reference smoke's checks in two acts:

1. boundedness: the master's merged series count stays under a bound that
   depends on the key union, never on the identity count, and the delta
   wire bytes per host per second ride the summary.
2. host-loss drill: the dumped per-process host digests are replayed into
   a fresh `FleetRollup` feeding an `AlertPlane` on a manual clock; one
   forced host loss must open exactly one incident whose attribution names
   the lost host, and the recovery must close it.

Then it writes rollup_report.json, the record the reference hands to
scripts/bench_check.py; that dry run is a bench gate and comes with the
port's benchmark (ROADMAP item 10a). The swarm runs the fake scheme on a
host device, as the reference's does: nothing here touches the card.

    python -m handel_tpu_torch.scripts.rollup_smoke [--artifact-dir DIR]
        [--identities N] [--processes M] [--series-bound K]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile
import time

from handel_tpu_torch.obs import AlertPlane
from handel_tpu_torch.obs.rollup import FleetRollup
from handel_tpu_torch.sim.config import AlertParams, SimConfig, SwarmParams
from handel_tpu_torch.swarm.driver import run_swarm


def host_loss_drill(digests: list[dict]) -> None:
    """Replay the host digests into a roll-up-fed AlertPlane on a manual
    clock and force one host loss: exactly one incident, its attribution
    naming the lost host, closed again on recovery."""
    t = {"now": 0.0}
    plane = AlertPlane.from_params(
        AlertParams(window_scale=0.01, min_hold_s=0.5, cooldown_s=2.0),
        clock=lambda: t["now"],
    )
    fleet = FleetRollup(stale_after_s=1.0, clock=lambda: t["now"])
    fleet.attach_alerts(plane)
    lost = digests[-1]["host"]

    def step(hosts):
        for d in hosts:
            fleet.ingest_digest(d, now=t["now"])
        plane.tick()
        t["now"] += 0.1

    while t["now"] < 2.0:  # healthy: every host reports
        step(digests)
    assert plane.incidents.opened == 0, "baseline opened an incident"
    assert fleet.hosts_up() == len(digests)

    while t["now"] < 4.0:  # the loss: the last host goes dark
        step(digests[:-1])
    inc = plane.incidents.current
    assert inc is not None, "host loss never opened an incident"
    assert inc.attribution["lost_hosts"] == [lost], (
        f"attribution missed the lost host: {inc.attribution['lost_hosts']}"
    )
    assert fleet.hosts_up() == len(digests) - 1

    while t["now"] < 7.0:  # recovery: the host reports again
        step(digests)
    assert plane.incidents.current is None, "incident never closed"
    assert plane.incidents.opened == 1, (
        f"expected exactly one incident, got {plane.incidents.opened}"
    )
    assert inc.state == "closed"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact-dir", default="",
                    help="keep rollup_report.json + fleet_rollup.json here")
    ap.add_argument("--identities", type=int, default=512)
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--series-bound", type=int, default=512,
                    help="the most merged series the master may hold")
    args = ap.parse_args(argv)
    if args.processes < 2:
        ap.error("the roll-up gate needs a fleet of two processes or more")

    cfg = SimConfig(
        swarm=SwarmParams(
            identities=args.identities,
            processes=args.processes,
            period_ms=10000.0,
            timeout_ms=50.0,
            fast_path=3,
            timeout_s=600.0,
        ),
    )

    with tempfile.TemporaryDirectory() as tmp:
        d = args.artifact_dir or tmp
        os.makedirs(d, exist_ok=True)
        summary = asyncio.run(run_swarm(cfg, d))

        assert summary["ok"], (
            f"only {summary['completed']}/{summary['swarm_identities']} "
            "vnodes reached threshold"
        )
        # -- act 1: boundedness ------------------------------------------------
        assert summary["fleet_hosts"] == args.processes
        series = summary["fleet_series_count"]
        assert 0 < series <= args.series_bound, (
            f"master holds {series} series for {args.identities} identities: "
            f"the roll-up leaked per-identity state (bound {args.series_bound})"
        )
        assert summary["rollup_bytes_per_host_s"] > 0
        assert summary["fleet_eval_ms"] >= 0
        with open(os.path.join(d, "fleet_rollup.json")) as f:
            fleet_doc = json.load(f)
        assert fleet_doc["fleet"]["hosts_up"] == args.processes
        assert len(fleet_doc["fleet"]["hosts"]) == args.processes

        # -- act 2: the host-loss drill ----------------------------------------
        digests = []
        for i in range(args.processes):
            with open(os.path.join(d, f"host_digest_{i}.json")) as f:
                digests.append(json.load(f))
        host_loss_drill(digests)

        # -- the record ------------------------------------------------------
        record = {
            "metric": "fleet_series_count",
            "value": series,
            "unit": "series",
            "backend": "cpu",
            "captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "fleet_series_count": series,
            "rollup_bytes_per_host_s": summary["rollup_bytes_per_host_s"],
            "fleet_eval_ms": summary["fleet_eval_ms"],
            "rollup": {
                "identities": args.identities,
                "processes": args.processes,
                "series_bound": args.series_bound,
                "hosts": fleet_doc["fleet"]["hosts_up"],
                "surfaces": fleet_doc["fleet"]["surfaces"],
                "ingest_bytes": fleet_doc["fleet"]["ingest_bytes"],
            },
        }
        report_path = os.path.join(d, "rollup_report.json")
        with open(report_path, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")

        print(
            f"rollup smoke OK: {args.identities} identities / "
            f"{args.processes} hosts -> {series} master series "
            f"(bound {args.series_bound}), "
            f"{summary['rollup_bytes_per_host_s']:.0f} B/host/s, "
            f"merge {summary['fleet_eval_ms']:.2f}ms, "
            "host-loss drill: exactly one incident, attributed, closed"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
