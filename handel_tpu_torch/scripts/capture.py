"""Capture simulation results into one combined CSV — counterpart of
scripts/capture.py.

Runs every `[[runs]]` entry of a simulation TOML through the port's sim
(`run_simulation`) and merges the per-run stats rows (one per run) into one
CSV: the shape of the Handel reference's result files (one row per run
with run/nodes/threshold/failing and the measure columns). The per-run work
directories land next to the output in `.work/` and are kept. Device
schemes run on the card unless HANDEL_TORCH_DEVICE=cpu names the CPU; the
repo's own captures run the fake or host schemes.

    python -m handel_tpu_torch.scripts.capture out.csv config.toml [--platform localhost]
"""

from __future__ import annotations

import argparse
import asyncio
import csv
import os
import sys

from handel_tpu_torch.sim.config import load_config
from handel_tpu_torch.sim.platform import run_simulation


def merge_csvs(paths: list[str], out: str) -> int:
    """Union-of-columns row merge, columns in sorted order."""
    rows: list[dict[str, str]] = []
    cols: set[str] = set()
    for p in paths:
        with open(p, newline="") as f:
            for row in csv.DictReader(f):
                rows.append(row)
                cols.update(row)
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=sorted(cols), restval="0")
        w.writeheader()
        for row in rows:
            w.writerow(row)
    return len(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("config")
    ap.add_argument("--platform", default="localhost")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    workdir = os.path.join(os.path.dirname(os.path.abspath(args.out)), ".work")
    results = asyncio.run(run_simulation(cfg, workdir, platform=args.platform))
    csvs = []
    for i, r in enumerate(results):
        print(f"run {i}: {'ok' if r.ok else 'FAILED'} -> {r.csv_path}", flush=True)
        if not r.ok:
            for _, err in r.outputs:
                sys.stderr.write(err.decode(errors="replace")[-2000:])
            return 1
        csvs.append(r.csv_path)
    n = merge_csvs(csvs, args.out)
    print(f"{args.out}: {n} rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
