"""Multi-tenant service gate: concurrent sessions through one verifier —
counterpart of scripts/service_smoke.py.

Three stages, all seconds on any machine (fake crypto):

1. Single-session baseline: one session of 16 nodes over a 64-lane shared
   verifier, for the launch fill a lone tenant reaches.
2. 8 concurrent 16-node sessions through ONE BatchVerifierService: every
   session must reach threshold, and the coalesced launch fill must beat
   the single-session baseline. The /metrics endpoint is scraped while it
   runs: the session-labeled service plane (`handel_service_*{session=...}`)
   must be there.
3. A 2-process `sim serve` fleet (4 sessions x 8 nodes over 2 workers): the
   driver's worker sharding, summary merge and service_summary.json.

Nothing here touches the card.

    python -m handel_tpu_torch.scripts.service_smoke
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import tempfile
import urllib.request

from handel_tpu_torch.core.metrics import parse_exposition
from handel_tpu_torch.service.driver import MultiSessionCluster, run_service
from handel_tpu_torch.sim.config import ServiceParams, SimConfig

SESSIONS, NODES, LANES = 8, 16, 64


async def run_shape(sessions: int, metrics: bool = False) -> dict:
    cluster = MultiSessionCluster(
        sessions, NODES, batch_size=LANES, metrics_port=0 if metrics else None,
    )
    addr = cluster.metrics_server.address if metrics else None
    scrape_task = None
    if addr:
        async def scrape_once():
            # poll until the session-labeled plane shows up mid-run
            for _ in range(200):
                text = await asyncio.to_thread(
                    lambda: urllib.request.urlopen(
                        f"http://{addr}/metrics", timeout=2
                    ).read().decode()
                )
                fams = parse_exposition(text)
                labeled = [
                    n for n, fam in fams.items()
                    if n.startswith("handel_service_")
                    and any("session" in lb for lb, _ in fam["samples"])
                ]
                if labeled:
                    return text, labeled
                await asyncio.sleep(0.01)
            return text, []

        scrape_task = asyncio.create_task(scrape_once())
    try:
        summary = await cluster.run(60.0)
        if scrape_task is not None:
            text, labeled = await scrape_task
            assert labeled, "no session-labeled handel_service_* families"
            assert "handel_device_verifier_launch_fill_ratio" in text
            summary["labeled_families"] = len(labeled)
        return summary
    finally:
        cluster.stop()


async def stage_serve_2proc(workdir: str) -> dict:
    cfg = SimConfig(
        scheme="fake",
        service=ServiceParams(sessions=4, nodes=8, processes=2,
                              session_ttl_s=30.0, batch_size=32),
        max_timeout_s=60.0,
    )
    summary = await run_service(cfg, workdir)
    assert summary["ok"], f"serve fleet failed: {summary}"
    assert summary["workers"] == 2
    assert summary["completed"] == 4
    path = os.path.join(workdir, "service_summary.json")
    assert os.path.exists(path), "service_summary.json not written"
    with open(path) as f:
        assert json.load(f)["sessions"] == 4
    return summary


def main(argv=None) -> int:
    base = asyncio.run(run_shape(1))
    assert base["completed"] == 1, base
    multi = asyncio.run(run_shape(SESSIONS, metrics=True))
    assert multi["completed"] == SESSIONS, (
        f"only {multi['completed']}/{SESSIONS} sessions reached threshold"
    )
    assert multi["expired"] == 0, multi
    assert multi["launch_fill_ratio"] > base["launch_fill_ratio"], (
        f"coalescing win missing: multi fill {multi['launch_fill_ratio']} "
        f"<= single-session baseline {base['launch_fill_ratio']}"
    )
    assert multi["coalesced_launches"] > 0, "no cross-session launches"
    with tempfile.TemporaryDirectory() as d:
        fleet = asyncio.run(stage_serve_2proc(d))
    print(json.dumps({
        "baseline_fill": base["launch_fill_ratio"],
        "multi_fill": multi["launch_fill_ratio"],
        "coalesced_launches": multi["coalesced_launches"],
        "aggregates_per_s": multi["aggregates_per_s"],
        "session_p99_s": multi["session_p99_s"],
        "labeled_families": multi["labeled_families"],
        "fleet_completed": fleet["completed"],
    }))
    print(
        f"service smoke OK: {SESSIONS} sessions fill "
        f"{multi['launch_fill_ratio']:.2f} vs single-session "
        f"{base['launch_fill_ratio']:.2f}, 2-process fleet completed "
        f"{fleet['completed']}/4"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
