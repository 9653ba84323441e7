"""Standalone master: sync barriers + monitor sink for multi-host runs — a
copy of handel_tpu/sim/master.py.

Reference: simul/master/main.go:36-118 — on a distributed deployment one
host runs the SyncMaster and the metrics Monitor while node processes on
other hosts connect over DCN; at END it writes the stats CSV. The localhost
platform embeds this role in-process (sim/platform.py); this entry point is
the multi-host form.

Usage: python -m handel_tpu_torch.sim.master --port 5555 --monitor-port 5556 \
           --expected 64 --csv results.csv [--timeout 600]
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from handel_tpu_torch.sim.monitor import DataFilter, Monitor
from handel_tpu_torch.sim.sync import STATE_END, STATE_START, SyncMaster


async def run_master(
    port: int,
    monitor_port: int,
    expected: int,
    csv: str,
    timeout: float,
    data_filter: DataFilter | None = None,
    extra: dict[str, float] | None = None,
    expected_keys: list[str] | None = None,
) -> int:
    monitor = Monitor(
        monitor_port, data_filter=data_filter, expected_keys=expected_keys or ()
    )
    # run/nodes/threshold/failing columns the plots key on (platform.py does
    # this in-process; the standalone master takes them from the CLI)
    monitor.stats.extra.update(extra or {})
    await monitor.start()
    sync = SyncMaster(port, expected)
    await sync.start()
    print(f"master: waiting for {expected} nodes on :{port}", flush=True)
    try:
        await sync.wait_all(STATE_START, timeout)
        print("master: START released", flush=True)
        await sync.wait_all(STATE_END, timeout)
        print("master: END released", flush=True)
        # linger: the barrier releases at the probabilistic fraction
        # (sync.go:92-98), so stragglers may still be resending READY —
        # keep acking briefly or they'd time out waiting for a dead master
        await asyncio.sleep(2.0)
    except asyncio.TimeoutError:
        print("master: barrier timeout", file=sys.stderr, flush=True)
        return 1
    finally:
        sync.stop()
        monitor.stop()
    if csv:
        monitor.stats.write_csv(csv)
        print(f"master: stats -> {csv}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--monitor-port", type=int, required=True)
    ap.add_argument("--expected", type=int, required=True)
    ap.add_argument("--csv", default="")
    ap.add_argument("--timeout", type=float, default=600.0)

    def _kv(spec: str) -> tuple[str, float]:
        key, eq, val = spec.partition("=")
        try:
            if not (key and eq):
                raise ValueError
            return key, float(val)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"expected KEY=NUMBER, got {spec!r}"
            ) from None

    ap.add_argument(
        "--filter",
        action="append",
        default=[],
        type=_kv,
        metavar="KEY=PCT",
        help="percentile outlier filter per stats key (stats.go DataFilter), "
        "e.g. --filter sigen_wall=99",
    )
    ap.add_argument(
        "--extra",
        action="append",
        default=[],
        type=_kv,
        metavar="KEY=VAL",
        help="constant CSV columns (run/nodes/threshold/failing) the plots "
        "key on, e.g. --extra nodes=4000 --extra threshold=3960",
    )
    args = ap.parse_args()
    pcts = dict(args.filter)
    return asyncio.run(
        run_master(
            args.port,
            args.monitor_port,
            args.expected,
            args.csv,
            args.timeout,
            data_filter=DataFilter(pcts) if pcts else None,
            extra=dict(args.extra),
        )
    )


if __name__ == "__main__":
    sys.exit(main())
