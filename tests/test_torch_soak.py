"""The port's lifecycle soak (handel_tpu_torch/sim/soak.py and the `soak`
subcommand) against the JAX package's.

Tolerance: `_gap_analysis` exact (the same dict for the same launch
times). The soaks are held by their report checks: a short soak of each
package, from results/geo_weighted.toml's [soak] table with its duration
cut, passes its own SOAK_CHECKS and the other package's, with the same
report keys; its walls and latencies follow the host.
"""

import asyncio
import json
import random
import subprocess
import sys
from pathlib import Path

import pytest

from handel_tpu.sim import config as rconfig
from handel_tpu.sim import report_checks as rchecks
from handel_tpu.sim import soak as rsoak
from handel_tpu_torch.sim import config as pconfig
from handel_tpu_torch.sim import report_checks as pchecks
from handel_tpu_torch.sim import soak as psoak

ROOT = Path(__file__).resolve().parents[1]
GEO_WEIGHTED = ROOT / "results" / "geo_weighted.toml"
SOAK_S = 4.0


@pytest.mark.parametrize("seed", range(6))
def test_gap_analysis_exact(seed):
    rng = random.Random(seed)
    n = rng.choice([0, 1, 2, 5, 50, 400])
    times = [rng.uniform(0.0, 30.0) for _ in range(n)]
    swaps = [None, -1.0, 31.0]
    if n:
        swaps += [rng.choice(times), rng.uniform(min(times), max(times))]
    for swap in swaps:
        assert psoak._gap_analysis(times, swap) == rsoak._gap_analysis(times, swap)
    for q in (0.0, 0.5, 0.99, 1.0):
        s = sorted(times)
        assert psoak._quantile(s, q) == rsoak._quantile(s, q)


def soak(cfg_mod, soak_mod, workdir):
    cfg = cfg_mod.load_config(str(GEO_WEIGHTED))
    cfg.soak.duration_s = SOAK_S
    return asyncio.run(soak_mod.run_soak(cfg.soak, str(workdir), alert_p=cfg.alerts))


def timing_of(report):
    """The figures the soak's two wall-clock checks read: `swap_bounded`
    (stall and swap gap against the bound) and `p99_within_slo` (each
    tier's p99 against its target)."""
    soak = report["soak"]
    return {
        "failed": sorted(k for k, ok in report["checks"].items() if not ok),
        "stall_ms": report["epoch_swap_stall_ms"],
        "swap_gap_ms": soak["gaps"]["swap_gap_ms"],
        "bound_ms": soak["swap_gap_bound_ms"],
        "p99_s": {name: tier["p99_s"] for name, tier in sorted(soak["tiers"].items())},
    }


def test_short_soak_beside_reference(tmp_path):
    ours = soak(pconfig, psoak, tmp_path / "port")
    theirs = soak(rconfig, rsoak, tmp_path / "ref")
    assert sorted(ours) == sorted(theirs)
    assert sorted(ours["soak"]) == sorted(theirs["soak"])
    assert [c.name for c in pchecks.SOAK_CHECKS] == [c.name for c in rchecks.SOAK_CHECKS]
    reports = (("port", ours), ("reference", theirs))
    # both soaks' wall-clock figures, whichever fails: a failure under load
    # then shows whether the other package's run came near its bounds too
    timing = {package: timing_of(report) for package, report in reports}
    for package, report in reports:
        failed = {
            c.name: c.describe(report)
            for c in pchecks.SOAK_CHECKS if not report["checks"][c.name]
        }
        assert report["ok"], (
            f"the {package}'s soak failed SOAK_CHECKS {failed}; both soaks: {timing}"
        )
        pchecks.assert_checks(report, pchecks.SOAK_CHECKS)
        rchecks.assert_checks(report, rchecks.SOAK_CHECKS)
    assert ours["soak"]["epoch_rotations"] == theirs["soak"]["epoch_rotations"] == 1
    assert json.loads((tmp_path / "port" / "soak_report.json").read_text())["ok"]


def test_soak_subcommand_runs_geo_weighted(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "handel_tpu_torch.sim", "soak", "--config", str(GEO_WEIGHTED),
         "--workdir", str(tmp_path / "k"), "--duration", str(SOAK_S)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["ok"], report["checks"]
    rchecks.assert_checks(report, rchecks.SOAK_CHECKS)


def soak_pairs(seconds: float, workdir: Path) -> None:
    """Run the short soak of each package in pairs for `seconds`, the port
    first in even pairs and the reference first in odd ones, and print one
    JSON line a pair with both soaks' `timing_of`, whether they pass or
    not. Beside a loaded host, this compares the two packages' timing
    checks under the same load:

        PYTHONPATH=. python tests/test_torch_soak.py SECONDS WORKDIR > pairs.jsonl
    """
    import tempfile
    import time

    deadline = time.monotonic() + seconds
    pair = 0
    while time.monotonic() < deadline:
        with tempfile.TemporaryDirectory(dir=workdir) as d:
            order = [("port", pconfig, psoak), ("reference", rconfig, rsoak)]
            if pair % 2:
                order.reverse()
            timing = {name: timing_of(soak(cfg, mod, Path(d) / name))
                      for name, cfg, mod in order}
        print(json.dumps({"pair": pair, "port_first": pair % 2 == 0, **timing}), flush=True)
        pair += 1


if __name__ == "__main__":
    soak_pairs(float(sys.argv[1]), Path(sys.argv[2]))


def test_soak_smoke(tmp_path, capsys):
    """The port's counterpart of scripts/soak_smoke.py, its load window cut
    from 90 s to 8 s: every SOAK_CHECKS predicate holds and the report is
    written."""
    from handel_tpu_torch.scripts import soak_smoke

    assert soak_smoke.main(["--duration", "8", "--artifact-dir", str(tmp_path)]) == 0
    assert "soak smoke: all lifecycle invariants held" in capsys.readouterr().out
    assert json.loads((tmp_path / "soak_report.json").read_text())["ok"]
