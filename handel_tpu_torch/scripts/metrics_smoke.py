"""Live-telemetry gate: boot a node fleet, scrape /metrics and /readyz —
counterpart of scripts/metrics_smoke.py.

Two stages, both seconds on any machine (fake crypto):

1. A localhost-platform run of the port's sim (8 nodes, one node process)
   with `metrics = true`: the smoke scrapes the process's endpoint while
   the run goes on, and asserts that /readyz answers 200 and that /metrics
   carries at least 20 metric families across the sigs, net and penalty
   planes.
2. An in-process LocalCluster wired to a stub-device BatchVerifierService:
   the same bar, plus the device_verifier plane that a single fake-scheme
   node process does not have, so all four planes (protocol, device
   verifier, network, penalties) are held.

Nothing here touches the card.

    python -m handel_tpu_torch.scripts.metrics_smoke
"""

from __future__ import annotations

import asyncio
import json
import sys
import tempfile
import time
import urllib.request

from handel_tpu_torch.core.metrics import parse_exposition
from handel_tpu_torch.core.test_harness import LocalCluster
from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
from handel_tpu_torch.sim import watch_cli
from handel_tpu_torch.sim.config import RunConfig, SimConfig
from handel_tpu_torch.sim.platform import run_simulation

MIN_FAMILIES = 20


def _families(text: str) -> set[str]:
    return {n for n in parse_exposition(text) if n.startswith("handel_")}


async def stage_node_process(workdir: str) -> set[str]:
    cfg = SimConfig(
        network="udp",
        scheme="fake",
        metrics=True,
        metrics_linger_s=2.0,
        max_timeout_s=30.0,
        runs=[RunConfig(nodes=8, threshold=8, processes=1)],
    )
    task = asyncio.create_task(run_simulation(cfg, workdir))
    deadline = time.monotonic() + 25
    fams: set[str] = set()
    ready = None
    while time.monotonic() < deadline and not task.done():
        for addr in watch_cli.discover_endpoints(workdir):
            got = await asyncio.to_thread(watch_cli.scrape, addr)
            if got is None:
                continue
            fams = _families(got[1])
            try:
                r = await asyncio.to_thread(
                    urllib.request.urlopen, f"http://{addr}/readyz", None, 2.0
                )
                ready = r.status
            except Exception:
                pass
        if fams and ready == 200:
            break
        await asyncio.sleep(0.2)
    results = await task
    assert results and results[0].ok, "sim run failed"
    assert ready == 200, f"/readyz never answered 200 (last: {ready})"
    assert len(fams) >= MIN_FAMILIES, f"only {len(fams)} families scraped: {sorted(fams)}"
    for plane in ("handel_sigs_", "handel_net_", "handel_penalty_"):
        assert any(n.startswith(plane) for n in fams), f"missing {plane}*"
    return fams


class _StubDevice:
    batch_size = 8

    def dispatch(self, msg, reqs):
        return len(reqs)

    def fetch(self, handle):
        return [True] * handle


async def stage_in_process() -> set[str]:
    svc = BatchVerifierService(_StubDevice(), max_delay_ms=0.1)
    cluster = LocalCluster(8, metrics_port=0, verifier_service=svc)
    addr = cluster.metrics_server.address
    cluster.start()
    finals = await cluster.wait_complete_success(10)
    assert len(finals) == 8
    text = urllib.request.urlopen(f"http://{addr}/metrics", timeout=3).read().decode()
    svc.stop()
    cluster.stop()
    fams = _families(text)
    assert len(fams) >= MIN_FAMILIES, sorted(fams)
    for plane in ("handel_sigs_", "handel_net_", "handel_penalty_",
                  "handel_device_verifier_"):
        assert any(n.startswith(plane) for n in fams), f"missing {plane}*"
    return fams


def main(argv=None) -> int:
    with tempfile.TemporaryDirectory() as d:
        fams1 = asyncio.run(stage_node_process(d))
    fams2 = asyncio.run(stage_in_process())
    print(json.dumps({
        "node_process_families": len(fams1),
        "in_process_families": len(fams2),
        "planes": sorted({n.split("_")[1] for n in fams1 | fams2}),
    }))
    print(f"metrics smoke OK: {len(fams1)}/{len(fams2)} families "
          f"(node-process/in-process), all planes present")
    return 0


if __name__ == "__main__":
    sys.exit(main())
