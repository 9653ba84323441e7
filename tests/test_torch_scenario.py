"""The port's scenario engine (handel_tpu_torch/scenario/: membership.py,
engine.py, and the `scenario` subcommand) against the JAX package's,
after tests/test_scenario.py.

Tolerance: membership schedules are compared event for event (times float
for float); `run_scenario` reports by their keys, checks, verdict, gate
(`weight_threshold`, exact), committee, churners, departures, joins and
epochs, not by their wall times and trace figures, which follow the host.
"""

import asyncio
import json
import subprocess
import sys
from pathlib import Path

import pytest

from handel_tpu.scenario import MembershipSchedule as JSchedule
from handel_tpu.scenario import run_scenario as j_run_scenario
from handel_tpu.sim import config as rconfig
from handel_tpu.sim import confgen as rconfgen
from handel_tpu_torch.scenario import MembershipSchedule, run_scenario
from handel_tpu_torch.sim import config as pconfig
from handel_tpu_torch.sim import confgen as pconfgen

ROOT = Path(__file__).resolve().parents[1]
GEO_WEIGHTED = ROOT / "results" / "geo_weighted.toml"


@pytest.mark.parametrize("nodes, churners, after, joins, at, seed", [
    (32, [29, 30, 31], 0.4, 2, 1.0, 5),
    (128, list(range(116, 128)), 0.4, 4, 0.4, 7),
    (8, [], 0.5, 0, 1.0, 0),
    (16, [15, 3, 9], 0.05, 1, 0.1, 123),
])
def test_membership_schedule_event_for_event(nodes, churners, after, joins, at, seed):
    kw = dict(churner_ids=churners, churn_after_s=after, joins=joins, join_at_s=at, seed=seed)
    ours, theirs = MembershipSchedule(nodes, **kw), JSchedule(nodes, **kw)
    as_tuples = lambda evs: [(e.at_s, e.kind, e.node_id) for e in evs]  # noqa: E731
    assert as_tuples(ours.events) == as_tuples(theirs.events)
    assert as_tuples(ours.leaves()) == as_tuples(theirs.leaves())
    assert as_tuples(ours.joins()) == as_tuples(theirs.joins())
    assert ours.final_size() == theirs.final_size() == nodes - len(churners) + joins
    for nid in [*churners, 0, nodes + 1]:
        assert ours.leave_time_of(nid) == theirs.leave_time_of(nid)


# report fields that do not follow the host's timing
STABLE = ("name", "planet", "regions", "nodes", "threshold", "failing", "churners",
          "departed_ids", "joins", "epochs_advanced", "weight_profile", "weight_threshold")


def stable(report: dict) -> dict:
    return {
        "keys": sorted(report), "scenario_keys": sorted(report["scenario"]),
        "metric": report["metric"], "backend": report["backend"], "ok": report["ok"],
        "checks": report["checks"], **{k: report["scenario"][k] for k in STABLE},
    }


def both(load, tmp_path, edit=lambda cfg: None):
    out = []
    for name, mod, runner in (("port", pconfig, run_scenario),
                              ("ref", rconfig, j_run_scenario)):
        cfg = load(mod)
        edit(cfg)
        work = tmp_path / name
        work.mkdir()
        out.append(asyncio.run(runner(cfg, str(work))))
        assert (work / "scenario_report.json").exists()
        assert (work / "scenario_trace.json").exists()
    return out


def test_geo_weighted_scenario_beside_reference(tmp_path):
    """results/geo_weighted.toml whole (128 nodes, the 5-region planet,
    pareto stake gated at 0.55, 12 churners, 4 joins through an epoch
    flip) through both engines."""
    ours, theirs = both(lambda mod: mod.load_config(str(GEO_WEIGHTED)), tmp_path)
    assert stable(ours) == stable(theirs)
    assert ours["ok"], ours["checks"]
    s = ours["scenario"]
    assert s["churners"] == 12 and s["joins"] == 4 and s["epochs_advanced"] == 1
    assert s["achieved_weight"] >= s["weight_threshold"] - 1e-9
    assert s["region_hops"]


@pytest.mark.parametrize("factory, nodes", [
    ("scenario_geo", 8), ("scenario_churn", 16), ("scenario_weighted", 16),
    ("scenario_geo_weighted", 32),
])
def test_confgen_scenarios_beside_reference(factory, nodes, tmp_path):
    """confgen's scenario configs (tests/test_scenario.py's end-to-end
    runs; the 32-node geo_weighted one is the reference's slow case)."""

    def load(mod):
        return (pconfgen if mod is pconfig else rconfgen).__dict__[factory](nodes)

    ours, theirs = both(load, tmp_path)
    assert stable(ours) == stable(theirs)
    assert ours["ok"], ours["checks"]


def test_scenario_subcommand_runs_geo_weighted(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "handel_tpu_torch.sim", "scenario", "--config",
         str(GEO_WEIGHTED), "--workdir", str(tmp_path / "s")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["ok"] and report["checks"] == {
        "threshold_reached": True, "departures_marked": True,
        "epoch_advanced": True, "region_attributed": True}
    assert json.loads((tmp_path / "s" / "scenario_report.json").read_text())["ok"]


def test_unreachable_weighted_threshold_is_refused_before_any_node(tmp_path):
    """The probe of tests/test_scenario.py's notes: a gate of 0.999 of the
    stake with churners is refused with the reference's message."""
    errs = []
    for mod, runner in ((pconfig, run_scenario), (rconfig, j_run_scenario)):
        cfg = mod.load_config(str(GEO_WEIGHTED))
        cfg.scenario.weight_threshold_frac = 0.999
        with pytest.raises(ValueError) as e:
            asyncio.run(runner(cfg, str(tmp_path)))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert not (tmp_path / "scenario_report.json").exists()


def test_scenario_smoke(tmp_path, capsys):
    """The port's counterpart of scripts/scenario_smoke.py at its default
    size (32 nodes, 3 regions, churn and a join)."""
    from handel_tpu_torch.scripts import scenario_smoke

    assert scenario_smoke.main(["--artifact-dir", str(tmp_path)]) == 0
    assert "scenario smoke: all WAN scenario invariants held" in capsys.readouterr().out
    assert json.loads((tmp_path / "scenario_report.json").read_text())["ok"]
