"""Swarm gate: 4096 virtual nodes reach threshold on one host — counterpart
of scripts/swarm_smoke.py.

Runs the port's `sim swarm` orchestrator (swarm/driver.py run_swarm) on a
4096-identity committee in <= 2 processes with tracing on, and asserts the
reference smoke's checks: every vnode reaches threshold, the windowed store
retired levels (the memory contract), the merged summary carries the three
bench-gated metrics, and the streamed trace report shows the per-level
completion wave plus a non-trivial critical path.

Gossip is set sparse (period 10 s): the in-memory router is lossless and
the id-staggered fast-path cascade covers every level deterministically,
so the run is fast-path-paced. The swarm runs the fake scheme on a host
device, as the reference's does: nothing here touches the card.

    python -m handel_tpu_torch.scripts.swarm_smoke [--artifact-dir DIR]
        [--identities N] [--processes M]

Prints one `swarm smoke OK` line, then the merged summary (without the
per-process parts) as one JSON line last.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile

from handel_tpu_torch.sim.config import SimConfig, SwarmParams
from handel_tpu_torch.swarm.driver import run_swarm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--artifact-dir", default="",
        help="keep swarm_summary.json + swarm_trace_report.json here",
    )
    ap.add_argument("--identities", type=int, default=4096)
    ap.add_argument("--processes", type=int, default=1)
    args = ap.parse_args(argv)
    if args.processes > 2:
        ap.error("the smoke gate is a <=2 process shape")

    cfg = SimConfig(
        trace=True,
        trace_capacity=1 << 20,
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
        assert summary["swarm_identities"] == args.identities
        # the three bench-gated metrics
        assert summary["mem_bytes_per_identity"] > 0
        assert summary["swarm_time_to_threshold_s"] > 0
        # the windowed store must retire completed levels: a silent
        # fallback to the plain store would pass completion but leak
        assert summary["retired_level_ct"] > 0, "no levels retired"
        if args.processes == 1:
            assert summary["udp_sent"] == 0.0, "single process sent UDP"
        else:
            assert summary["udp_sent"] > 0, "blocks never crossed the socket"

        rep = summary.get("trace_report") or {}
        wave = rep.get("level_wave") or {}
        assert wave, "trace report has no level-completion wave"
        for lvl, w in wave.items():
            assert w["first"] <= w["median"] <= w["last"], (
                f"level {lvl} wave out of order: {w}"
            )
        assert rep.get("critical_path_len", 0) >= 1

        print(
            f"swarm smoke OK: {summary['swarm_identities']} vnodes / "
            f"{summary['processes']} proc, "
            f"ttt {summary['swarm_time_to_threshold_s']:.1f}s, "
            f"{summary['mem_bytes_per_identity']:.0f} B/identity, "
            f"{summary['retired_level_ct']} levels retired, "
            f"wave levels {sorted(wave, key=int)}"
        )
        print(json.dumps({k: v for k, v in summary.items() if k != "per_process"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
