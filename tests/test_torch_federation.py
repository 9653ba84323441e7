"""The port's federation and open-loop load (handel_tpu_torch/service/
federation.py, sim/load.py and the `load` subcommand) against the JAX
package's, after tests/test_federation.py.

Tolerance: exact for the arrival clock (`rate_at`, `peak_rate`,
`arrival_offsets`: float for float), route orders, backoff ladders and
the failure lattice's outcomes and counters. The load runs are held by
their report checks: each package's report passes its own
FEDERATION_CHECKS and the other package's, with the same keys and the
same accounting identity; their latencies follow the host.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
from pathlib import Path

import pytest

from handel_tpu.service import federation as rfed
from handel_tpu.sim import config as rconfig
from handel_tpu.sim import load as rload
from handel_tpu.sim import report_checks as rchecks
from handel_tpu_torch.service import federation as pfed
from handel_tpu_torch.sim import config as pconfig
from handel_tpu_torch.sim import load as pload
from handel_tpu_torch.sim import report_checks as pchecks

ROOT = Path(__file__).resolve().parents[1]
SIDES = {"port": (pfed, pconfig, pload, pchecks), "ref": (rfed, rconfig, rload, rchecks)}


def fast_params(mod, **kw):
    """CI-speed federation: tiny RTTs, tiny retry waits, small registry
    (tests/test_federation.py `_fast_params`)."""
    base = dict(planet="planet-3region-fast", retry_base_ms=5.0, retry_cap_ms=20.0,
                probe_interval_s=0.05, session_ttl_s=10.0, registry=16,
                trace_capacity=1 << 12)
    base.update(kw)
    return mod.FederationParams(**base)


# -- the arrival clock ---------------------------------------------------------


LOADS = [
    dict(rate_sps=20.0, duration_s=10.0, seed=3),
    dict(rate_sps=20.0, duration_s=10.0, seed=4),
    dict(rate_sps=10.0, duration_s=40.0, model="diurnal", diurnal_amplitude=0.5,
         diurnal_period_s=40.0, seed=5),
    dict(rate_sps=10.0, duration_s=40.0, model="burst", seed=11, burst_every_s=10.0,
         burst_x=6.0, burst_len_s=2.0),
    dict(rate_sps=4.0, duration_s=8.0, seed=0),
]


@pytest.mark.parametrize("kw", LOADS)
def test_rate_at_and_arrival_offsets_exact(kw):
    ours, theirs = pconfig.LoadParams(**kw), rconfig.LoadParams(**kw)
    for i in range(400):
        t = i * kw["duration_s"] / 400
        assert pload.rate_at(ours, t) == rload.rate_at(theirs, t)
    assert pload.peak_rate(ours) == rload.peak_rate(theirs)
    a = pload.arrival_offsets(ours)
    assert a == rload.arrival_offsets(theirs)
    assert a == sorted(a) and all(0.0 <= t < kw["duration_s"] for t in a)


# -- routing and backoff -------------------------------------------------------


@pytest.mark.parametrize("planet", ["planet-3region-fast", "planet-3region", "planet-5region"])
def test_route_order_exact(planet):
    ours = pfed.Federation(fast_params(pconfig, planet=planet))
    theirs = rfed.Federation(fast_params(rconfig, planet=planet))
    assert ours.region_names() == theirs.region_names()
    names = ours.region_names()
    for origin in names:
        assert ours.front_door.route_order(origin) == theirs.front_door.route_order(origin)
    for down in names:
        ours.front_door.mark(down, False)
        theirs.front_door.mark(down, False)
        for origin in names:
            assert ours.front_door.route_order(origin) == \
                theirs.front_door.route_order(origin)
        ours.front_door.mark(down, True)
        theirs.front_door.mark(down, True)
    assert ours.values() == theirs.values()


@pytest.mark.parametrize("base, cap", [(50.0, 400.0), (5.0, 20.0), (10.0, 10.0)])
def test_backoff_exact(base, cap):
    ours = pfed.Federation(fast_params(pconfig, retry_base_ms=base, retry_cap_ms=cap))
    theirs = rfed.Federation(fast_params(rconfig, retry_base_ms=base, retry_cap_ms=cap))
    assert [ours.front_door.backoff_ms(a) for a in range(8)] == \
        [theirs.front_door.backoff_ms(a) for a in range(8)]


# -- the failure lattice, in both packages --------------------------------------


def lattice(side: str, monkeypatch) -> dict:
    fed_mod, cfg_mod = SIDES[side][:2]
    out = {}

    async def go():
        fed = fed_mod.Federation(fast_params(cfg_mod))
        fed.start()
        try:
            fed.kill_region("eu-west")
            outcome, s, plane, _ = await fed.submit("eu-west", nodes=4, tier="gold", seed=1)
            out["spill"] = (outcome, plane.name, fed.front_door.spillovers, plane.spill_in,
                            fed.front_door.health["eu-west"])
            while not s.finished:
                await asyncio.sleep(0.01)
            stall = await fed.recover_region("eu-west")
            fed.front_door.probe_now()
            out["recover"] = (stall >= 0.0, fed.epoch,
                              [p.cluster.manager.epoch for p in fed.planes],
                              fed.front_door.route_order("eu-west"))
            outcome, s, plane, _ = await fed.submit("eu-west", nodes=4, tier="gold", seed=5)
            out["readmit"] = (outcome, plane.name)
            while not s.finished:
                await asyncio.sleep(0.01)
        finally:
            await fed.stop()

        fed = fed_mod.Federation(fast_params(cfg_mod, retry_budget=2))
        fed.start()
        try:
            for name in fed.region_names():
                fed.kill_region(name)
            outcome, s, plane, attempts = await fed.submit("us-east", nodes=4, tier="gold",
                                                           seed=2)
            out["dead"] = (outcome, s, plane, attempts, fed.front_door.failures,
                           fed.front_door.retries)
        finally:
            await fed.stop()

        fed = fed_mod.Federation(fast_params(cfg_mod, retry_budget=2))
        fed.start()
        try:
            with monkeypatch.context() as m:
                m.setattr(fed_mod.RegionPlane, "shedding", lambda self, tier: True)
                outcome, s, _, attempts = await fed.submit("ap-east", nodes=4, tier="bronze",
                                                           seed=3)
            out["shed"] = (outcome, s, attempts, fed.front_door.sheds, fed.front_door.failures)
        finally:
            await fed.stop()

    asyncio.run(go())
    return out


def test_failure_lattice_beside_reference(monkeypatch):
    ours = lattice("port", monkeypatch)
    assert ours == lattice("ref", monkeypatch)
    assert ours["spill"] == ("admitted", "us-east", 1, 1, False)
    assert ours["recover"][1:] == (1, [1, 1, 1], ["eu-west", "us-east", "ap-east"])
    assert ours["readmit"] == ("admitted", "eu-west")
    assert ours["dead"] == ("failed", None, None, 2, 1, 2)
    assert ours["shed"] == ("shed", None, 2, 1, 0)


def test_region_shed_bound_and_unknown_kill_region_alike(monkeypatch):
    errors = []
    for side in ("port", "ref"):
        fed_mod, cfg_mod, load_mod = SIDES[side][:3]
        fed = fed_mod.Federation(fast_params(cfg_mod))
        plane = fed.by_name["eu-west"]
        with monkeypatch.context() as m:
            m.setattr(type(plane.cluster.service.queue), "__len__", lambda self: 10**6)
            with pytest.raises(fed_mod.RegionShedding):
                plane.admit(nodes=4, tier="gold", seed=4)
        assert plane.sheds == 1
        with pytest.raises(ValueError) as e:
            load_mod.LoadRun(cfg_mod.LoadParams(rate_sps=1.0),
                             fast_params(cfg_mod, kill_region="mars-north"))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# -- a short open-loop run with the kill drill ----------------------------------


def load_run(side: str, workdir: Path) -> dict:
    _, cfg_mod, load_mod, _ = SIDES[side]
    lp = cfg_mod.LoadParams(rate_sps=6.0, duration_s=6.0, nodes=4, seed=2, deadline_s=5.0)
    fp = fast_params(cfg_mod, kill_region="us-east", kill_at_frac=0.3, recover_at_frac=0.6,
                     trace_capacity=1 << 16)
    return asyncio.run(load_mod.run_load(lp, fp, str(workdir)))


def test_load_run_with_kill_drill_beside_reference(tmp_path):
    ours, theirs = load_run("port", tmp_path / "port"), load_run("ref", tmp_path / "ref")
    assert sorted(ours) == sorted(theirs)
    assert sorted(ours["federation"]) == sorted(theirs["federation"])
    assert [c.name for c in pchecks.FEDERATION_CHECKS] == \
        [c.name for c in rchecks.FEDERATION_CHECKS]
    for report in (ours, theirs):
        assert report["ok"], report["checks"]
        pchecks.assert_checks(report, pchecks.FEDERATION_CHECKS)
        rchecks.assert_checks(report, rchecks.FEDERATION_CHECKS)
        fed = report["federation"]
        assert fed["unaccounted"] == 0 and fed["unresolved"] == 0
        assert fed["arrivals"] == fed["completed"] + fed["shed"] + fed["failed"] + fed["expired"]
        assert fed["kill"]["recovery_s"] is not None
    # the same seeded arrival clock in both
    assert ours["federation"]["arrivals"] == theirs["federation"]["arrivals"]
    events = json.loads((tmp_path / "port" / "trace_federation.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "federation"}
    assert {"region_kill", "region_recover", "frontdoor_route"} <= names


def test_load_subcommand_runs_beside_geo_weighted(tmp_path):
    """`python -m handel_tpu_torch.sim load` from results/geo_weighted.toml
    (which has no [load] table: --rate turns it on, as for the reference)."""
    out = subprocess.run(
        [sys.executable, "-m", "handel_tpu_torch.sim", "load", "--config",
         str(ROOT / "results" / "geo_weighted.toml"), "--workdir", str(tmp_path / "l"),
         "--duration", "3", "--rate", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["ok"], report["checks"]
    rchecks.assert_checks(report, rchecks.FEDERATION_CHECKS)
    assert (tmp_path / "l" / "federation_report.json").exists()
    # without --rate the table is off, and the subcommand refuses as the
    # reference's does
    out = subprocess.run(
        [sys.executable, "-m", "handel_tpu_torch.sim", "load", "--config",
         str(ROOT / "results" / "geo_weighted.toml"), "--workdir", str(tmp_path / "m")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 2 and "rate_sps must be > 0" in out.stderr
