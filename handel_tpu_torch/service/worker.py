"""Service worker process: one shard of a `sim serve` session load — a copy
of handel_tpu/service/worker.py.

Spawned by service/driver.py `run_service` when `[service].processes > 1`:
each worker multiplexes its share of the sessions onto its OWN shared
`BatchVerifierService` (one verify plane per process — the fleet analog of
the per-process shared verifier in sim/node.py), optionally serves
/metrics with the session-labeled plane, and reports its summary on stdout
as one `SERVICE_RESULT {json}` line for the driver to merge.

Run as: python -m handel_tpu_torch.service.worker --config serve.toml
            --index I --sessions K [--metrics-port P]
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import sys


async def run_worker(args) -> int:
    from handel_tpu_torch.sim.config import load_config
    from handel_tpu_torch.service.driver import run_in_process

    cfg = load_config(args.config)
    # this worker runs `--sessions` of the total; seeds are disjoint per
    # worker so no two workers build identical committees
    cfg.service = dataclasses.replace(cfg.service, sessions=args.sessions)
    summary = await run_in_process(
        cfg,
        seed_base=args.index * 1_000_000,
        metrics_port=args.metrics_port if args.metrics_port >= 0 else None,
    )
    summary["worker"] = args.index
    print("SERVICE_RESULT " + json.dumps(summary), flush=True)
    return 0 if summary["expired"] == 0 else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--sessions", type=int, required=True)
    ap.add_argument("--metrics-port", type=int, default=-1)
    return asyncio.run(run_worker(ap.parse_args()))


if __name__ == "__main__":
    sys.exit(main())
