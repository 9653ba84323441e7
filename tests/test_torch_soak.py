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


def test_short_soak_beside_reference(tmp_path):
    ours = soak(pconfig, psoak, tmp_path / "port")
    theirs = soak(rconfig, rsoak, tmp_path / "ref")
    assert sorted(ours) == sorted(theirs)
    assert sorted(ours["soak"]) == sorted(theirs["soak"])
    assert [c.name for c in pchecks.SOAK_CHECKS] == [c.name for c in rchecks.SOAK_CHECKS]
    for report in (ours, theirs):
        assert report["ok"], report["checks"]
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
