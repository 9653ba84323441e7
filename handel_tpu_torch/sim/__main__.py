"""Simulation orchestrator CLI — the base run of handel_tpu/sim/__main__.py.

Reference: simul/main.go:24-68 — load the TOML config, run each RunConfig
in order on the chosen platform, abort a run after MaxTimeout.

Usage: python -m handel_tpu_torch.sim --config sim.toml --workdir out/
           [--platform localhost|remote]
       python -m handel_tpu_torch.sim trace <trace-dir>   (analyze a traced run)
       python -m handel_tpu_torch.sim watch sim.toml      (live /metrics dashboard)
       python -m handel_tpu_torch.sim confgen --scenario geo     (emit TOMLs)
       python -m handel_tpu_torch.sim serve sim.toml      (multi-session service)
       python -m handel_tpu_torch.sim soak                (lifecycle soak proof)
       python -m handel_tpu_torch.sim load                (open-loop federation load)
       python -m handel_tpu_torch.sim scenario --config s.toml   (WAN scenario)

The node processes run their device scheme on the card unless
HANDEL_TORCH_DEVICE=cpu (utils/torchenv.py). `serve` runs its sessions on
the fake or a host scheme and refuses a device scheme, as the reference
does (service/driver.py run_in_process); `soak`, `load` and `scenario` run
on the fake scheme and host devices, as the reference's do, and read no
scheme from the TOML. `swarm` is not ported yet: it exits non-zero naming
its ROADMAP item.
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
    if len(sys.argv) > 1 and sys.argv[1] == "soak":
        # lifecycle soak subcommand (sim/soak.py): a continuously-loaded
        # service run with a mid-run epoch swap and a forced lane loss
        kap = argparse.ArgumentParser(prog="python -m handel_tpu_torch.sim soak")
        kap.add_argument("--config", default="", help="TOML with a [soak] section")
        kap.add_argument("--workdir", default="soak_out")
        kap.add_argument("--duration", type=float, default=0.0,
                         help="override [soak] duration_s")
        kargs = kap.parse_args(sys.argv[2:])
        from handel_tpu_torch.sim.config import AlertParams, SoakParams
        from handel_tpu_torch.sim.soak import run_soak

        if kargs.config:
            kcfg = load_config(kargs.config)
            p, al = kcfg.soak, kcfg.alerts
        else:
            p, al = SoakParams(), AlertParams()
        if kargs.duration > 0:
            p.duration_s = kargs.duration
        report = asyncio.run(run_soak(p, kargs.workdir, alert_p=al))
        print(json.dumps(report))
        return 0 if report["ok"] else 1
    if len(sys.argv) > 1 and sys.argv[1] == "load":
        # open-loop load subcommand (sim/load.py): seeded Poisson/diurnal/
        # burst arrivals against a geo-federated verify plane with an
        # optional mid-run region kill and recovery drill; writes
        # federation_report.json into --workdir
        lap = argparse.ArgumentParser(prog="python -m handel_tpu_torch.sim load")
        lap.add_argument("--config", default="",
                         help="TOML with [load] (+ optional [federation])")
        lap.add_argument("--workdir", default="load_out")
        lap.add_argument("--duration", type=float, default=0.0,
                         help="override [load] duration_s")
        lap.add_argument("--rate", type=float, default=0.0,
                         help="override [load] rate_sps")
        lap.add_argument("--metrics-port", type=int, default=None,
                         help="serve /metrics while the run is live")
        largs = lap.parse_args(sys.argv[2:])
        from handel_tpu_torch.sim.config import (
            AlertParams,
            FederationParams,
            LoadParams,
        )
        from handel_tpu_torch.sim.load import run_load

        if largs.config:
            lcfg = load_config(largs.config)
            lo, fe, al = lcfg.load, lcfg.federation, lcfg.alerts
        else:
            lo, fe, al = (
                LoadParams(rate_sps=4.0), FederationParams(), AlertParams()
            )
        if largs.duration > 0:
            lo.duration_s = largs.duration
        if largs.rate > 0:
            lo.rate_sps = largs.rate
        if not lo.enabled():
            lap.error("[load] rate_sps must be > 0 (or pass --rate)")
        report = asyncio.run(
            run_load(lo, fe, largs.workdir,
                     metrics_port=largs.metrics_port, alert_p=al)
        )
        print(json.dumps(report))
        return 0 if report["ok"] else 1
    if len(sys.argv) > 1 and sys.argv[1] == "scenario":
        # WAN scenario subcommand (scenario/engine.py): run the [scenario]
        # TOML section's composed geo/churn/weights run in one process and
        # write the report and trace into --workdir
        zap = argparse.ArgumentParser(
            prog="python -m handel_tpu_torch.sim scenario"
        )
        zap.add_argument("--config", required=True,
                         help="TOML with a [scenario] section")
        zap.add_argument("--workdir", default="scenario_out")
        zargs = zap.parse_args(sys.argv[2:])
        import os

        from handel_tpu_torch.scenario import run_scenario

        cfg = load_config(zargs.config)
        os.makedirs(zargs.workdir, exist_ok=True)
        report = asyncio.run(run_scenario(cfg, zargs.workdir))
        print(json.dumps(report))
        return 0 if report["ok"] else 1
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
