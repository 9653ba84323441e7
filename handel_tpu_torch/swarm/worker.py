"""Swarm worker process: one contiguous vnode block of the committee — a
copy of handel_tpu/swarm/worker.py.

Spawned by `run_swarm` (swarm/driver.py) as
`python -m handel_tpu_torch.swarm.worker --config <toml> --index <i> --workdir <d>`.
Reads the `[swarm]` section plus the parent's `swarm_ports.json`, binds its
shared UDP socket, builds its vnodes (registering every listener), joins the
START barrier — no process gossips until every block can receive — runs to
completion, dumps its trace file, and reports its summary as one
`SWARM_RESULT {json}` stdout line (the service/worker.py convention).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys


async def run_worker(args) -> int:
    from handel_tpu_torch.sim.config import load_config
    from handel_tpu_torch.sim.sync import STATE_END, STATE_START, SyncSlave
    from handel_tpu_torch.swarm.driver import _split, host_from_params

    cfg = load_config(args.config)
    p = cfg.swarm
    with open(os.path.join(args.workdir, "swarm_ports.json")) as f:
        ports = json.load(f)
    shares = _split(p.identities, max(1, p.processes))
    lo = sum(shares[: args.index])
    hi = lo + shares[args.index]

    host = host_from_params(
        p,
        lo,
        hi,
        block=shares[0],
        ports=ports["swarm"],
        proc_index=args.index,
        trace=cfg.trace,
        trace_capacity=cfg.trace_capacity,
        rollup_top_k=cfg.alerts.rollup_top_k,
    )
    await host.router.open(ports["swarm"][args.index])
    host.build()

    slave = SyncSlave(f"127.0.0.1:{ports['sync']}", args.index)
    await slave.start()
    timeout = p.timeout_s or cfg.max_timeout_s
    await slave.signal_and_wait(STATE_START, timeout=timeout)
    if host.recorder is not None:
        # barrier handshake clock estimate -> trace alignment at merge
        host.recorder.clock_offset = slave.clock_offset

    summary = await host.run(timeout, teardown=False)
    # END barrier before teardown: our block is done but siblings may still
    # need our contributions — closing the router now would strand them
    try:
        await slave.signal_and_wait(STATE_END, timeout=timeout)
    except asyncio.TimeoutError:
        pass  # a straggling sibling shouldn't wedge our report
    host.stop()
    slave.stop()
    with open(
        os.path.join(args.workdir, f"swarm_rollup_{args.index}.json"), "w"
    ) as f:
        json.dump(host.rollup(), f)
    # hierarchical roll-up: the bounded host digest the master's
    # FleetRollup merges (obs/rollup.py) + the wire bytes a live chunked
    # delta emission would have cost — O(key-union), never O(identities)
    digest = host.host_rollup.digest()
    summary["rollup_bytes"] = host.host_rollup.emit()
    with open(
        os.path.join(args.workdir, f"host_digest_{args.index}.json"), "w"
    ) as f:
        json.dump(digest, f)
    if host.recorder is not None:
        host.recorder.dump(
            os.path.join(args.workdir, f"swarm_trace_{args.index}.json")
        )
    print("SWARM_RESULT " + json.dumps(summary), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--index", type=int, required=True)
    ap.add_argument("--workdir", required=True)
    return asyncio.run(run_worker(ap.parse_args()))


if __name__ == "__main__":
    sys.exit(main())
