"""Simulation orchestrator CLI — the base run of handel_tpu/sim/__main__.py.

Reference: simul/main.go:24-68 — load the TOML config, run each RunConfig
in order on the chosen platform, abort a run after MaxTimeout.

Usage: python -m handel_tpu_torch.sim --config sim.toml --workdir out/
           [--platform localhost|remote]
       python -m handel_tpu_torch.sim trace <trace-dir>   (analyze a traced run)
       python -m handel_tpu_torch.sim watch sim.toml      (live /metrics dashboard)
       python -m handel_tpu_torch.sim confgen --scenario geo     (emit TOMLs)
       python -m handel_tpu_torch.sim serve sim.toml      (multi-session service)

The node processes run their device scheme on the card unless
HANDEL_TORCH_DEVICE=cpu (utils/torchenv.py). `serve` runs its sessions on
the fake or a host scheme and refuses a device scheme, as the reference
does (service/driver.py run_in_process). The reference's other
subcommands are not ported yet: each exits non-zero naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from handel_tpu_torch.sim.config import load_config
from handel_tpu_torch.sim.platform import run_simulation

#: subcommand -> ROADMAP item that ports it
NOT_PORTED = {
    "swarm": "8 (swarm/)",
    "soak": "8 (sim/soak.py)",
    "load": "8 (sim/load.py)",
    "scenario": "8 (scenario/)",
}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "trace":
        # trace-analysis subcommand (sim/trace_cli.py): reconstruct the
        # aggregation wave + span attribution from flight-recorder dumps
        from handel_tpu_torch.sim.trace_cli import main as trace_main

        return trace_main(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "watch":
        # live-telemetry subcommand (sim/watch_cli.py): launch a run with
        # metrics on and render its endpoints, or --attach to a run dir
        from handel_tpu_torch.sim.watch_cli import main as watch_main

        return watch_main(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "confgen":
        # experiment-matrix generator (sim/confgen.py): emit ready-to-run
        # TOMLs; --scenario narrows to named entries (geo, churn,
        # weighted, geo_weighted, node_count, ...), default = all
        gap = argparse.ArgumentParser(
            prog="python -m handel_tpu_torch.sim confgen"
        )
        gap.add_argument(
            "--scenario", action="append", default=None,
            help="scenario name (repeatable); omit for the full matrix",
        )
        gap.add_argument("--outdir", default="configs")
        gargs = gap.parse_args(sys.argv[2:])
        from handel_tpu_torch.sim.confgen import generate

        for p in generate(gargs.outdir, gargs.scenario):
            print(p)
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "serve":
        # multi-tenant service subcommand (service/driver.py): run the
        # [service] TOML section's K concurrent sessions over M worker
        # processes, one shared BatchVerifierService per process
        sap = argparse.ArgumentParser(prog="python -m handel_tpu_torch.sim serve")
        sap.add_argument("config")
        sap.add_argument("--workdir", default="serve_out")
        sargs = sap.parse_args(sys.argv[2:])
        from handel_tpu_torch.service.driver import run_service

        cfg = load_config(sargs.config)
        summary = asyncio.run(run_service(cfg, sargs.workdir, sargs.config))
        print(json.dumps(summary))
        return 0 if summary["ok"] else 1
    if len(sys.argv) > 1 and sys.argv[1] in NOT_PORTED:
        sub = sys.argv[1]
        print(
            f"python -m handel_tpu_torch.sim {sub}: not ported yet "
            f"(ROADMAP item {NOT_PORTED[sub]})",
            file=sys.stderr,
        )
        return 2
    ap = argparse.ArgumentParser(prog="python -m handel_tpu_torch.sim")
    ap.add_argument("--config", required=True)
    ap.add_argument("--workdir", default="sim_out")
    # platform dispatch (simul/main.go -platform flag)
    ap.add_argument("--platform", default="localhost")
    args = ap.parse_args()
    cfg = load_config(args.config)
    results = asyncio.run(run_simulation(cfg, args.workdir, platform=args.platform))
    ok = all(r.ok for r in results)
    for i, r in enumerate(results):
        status = "success" if r.ok else "FAILED"
        print(f"run {i}: {status} -> {r.csv_path}")
        if not r.ok:
            for out, err in r.outputs:
                if err:
                    sys.stderr.write(err.decode(errors="replace"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
