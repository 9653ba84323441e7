"""The port's geo planet model (handel_tpu_torch/network/geo.py,
scenario/planets.py) against the JAX package's.

The same presets and inline matrices give the same validated GeoConfig, the
same region placement and seeds per node, and the same seeded per-pair
delays, sample after sample (exact: the delays are Python floats from the
same `random.Random` streams). `[scenario]` TOMLs resolve to the same
planet in both packages; a geo round through the port's harness tags its
spans with each node's region; and a geo localhost run through both
platforms writes the same CSV columns, the WAN delay histogram included.
"""

import asyncio
import math

import pytest

from handel_tpu.core.identity import Identity as RIdentity
from handel_tpu.models.fake import FakePublic as RFakePublic
from handel_tpu.network.geo import GeoConfig as RGeo
from handel_tpu.network.geo import GeoNetwork as RGeoNet
from handel_tpu.scenario import planets as rplanets
from handel_tpu.sim import config as rconfig
from handel_tpu.sim.platform import LocalhostPlatform as RPlatform
from handel_tpu_torch.core.identity import Identity as PIdentity
from handel_tpu_torch.models.fake import FakePublic as PFakePublic
from handel_tpu_torch.network.chaos import ChaosConfig as PChaos
from handel_tpu_torch.network.geo import GeoConfig as PGeo
from handel_tpu_torch.network.geo import GeoNetwork as PGeoNet
from handel_tpu_torch.scenario import planets as pplanets
from handel_tpu_torch.sim import config as pconfig
from handel_tpu_torch.sim.platform import LocalhostPlatform as PPlatform

INLINE = (
    ["north", "south", "east", "west"],
    [[1.0, 30.0, 55.0, 80.0], [30.0, 2.0, 45.0, 60.0],
     [55.0, 45.0, 0.5, 25.0], [80.0, 60.0, 25.0, 3.0]],
)


class Inner:
    """A transport that records what the geo wrapper hands it."""

    def __init__(self):
        self.sent = []

    def send(self, idents, packet):
        self.sent.append(([i.id for i in idents], packet))


def planets_of():
    return [INLINE] + [pplanets.planet_preset(n) for n in pplanets.planet_names()]


def test_planet_presets_are_the_reference_s():
    assert pplanets.PLANETS == rplanets.PLANETS
    assert pplanets.planet_names() == rplanets.planet_names()
    for name in pplanets.planet_names():
        assert pplanets.planet_preset(name) == rplanets.planet_preset(name)
    for mod in (pplanets, rplanets):
        with pytest.raises(ValueError, match="unknown planet"):
            mod.planet_preset("planet-unknown")


@pytest.mark.parametrize("which", range(4), ids=["inline", *pplanets.planet_names()])
@pytest.mark.parametrize("jitter, seed", [(0.0, 0), (3.0, 7), (12.5, 99)])
def test_delay_matrix_and_per_pair_delays_match(which, jitter, seed):
    regions, rtt = planets_of()[which]
    n = 3 * len(regions) + 1
    pin = {n - 1: 0}  # one node pinned off its round-robin region
    ours = PGeo(regions=regions, rtt_ms=rtt, jitter_ms=jitter, seed=seed, assignment=pin)
    theirs = RGeo(regions=regions, rtt_ms=rtt, jitter_ms=jitter, seed=seed, assignment=pin)
    assert ours.validate() is ours and theirs.validate() is theirs
    for a in range(len(regions)):
        for b in range(len(regions)):
            assert ours.rtt(a, b) == theirs.rtt(regions[a], regions[b])
    for src in range(n):
        po, pt = ours.for_node(src), theirs.for_node(src)
        assert (po.node_id, po.seed) == (pt.node_id, pt.seed)
        assert po.region_of(src) == pt.region_of(src)
        net_o, net_t = PGeoNet(Inner(), po), RGeoNet(Inner(), pt)
        assert net_o.region == net_t.region
        for _ in range(3):
            for dst in range(n):
                got = net_o.sample_delay_ms(PIdentity(dst, f"n-{dst}", PFakePublic(True)))
                want = net_t.sample_delay_ms(RIdentity(dst, f"n-{dst}", RFakePublic(True)))
                assert got == want and got >= 0.0
                if not jitter:
                    assert got == rtt[po.region_index(src)][po.region_index(dst)] / 2.0


@pytest.mark.parametrize(
    "bad",
    [dict(regions=()), dict(rtt_ms=[[0.0, 1.0]]), dict(rtt_ms=[[0.0, -1.0], [1.0, 0.0]]),
     dict(jitter_ms=-1.0), dict(assignment={3: 2})],
    ids=["no-regions", "shape", "negative-rtt", "negative-jitter", "assignment"],
)
def test_malformed_configs_are_refused_alike(bad):
    kw = {"regions": ("a", "b"), "rtt_ms": [[0.0, 1.0], [1.0, 0.0]], **bad}
    for cls in (PGeo, RGeo):
        with pytest.raises(ValueError):
            cls(**kw).validate()
    for cfg in (PGeo(regions=("a",), rtt_ms=[[0.0]]), RGeo(regions=("a",), rtt_ms=[[0.0]])):
        with pytest.raises(ValueError, match="unknown region"):
            cfg.rtt("a", "z")


def test_delivery_counts_and_histogram_match():
    """Chaos faults and WAN delay composed: the same packets are dropped,
    delivered at once or held, with the same counters and histogram, and
    the wrapped transport sees the same sends."""
    from handel_tpu.core.net import Packet as RPacket
    from handel_tpu.network.chaos import ChaosConfig as RChaos
    from handel_tpu_torch.core.net import Packet as PPacket

    regions, rtt = INLINE
    rtt = [[0.0 if i == j else v for j, v in enumerate(row)] for i, row in enumerate(rtt)]
    chaos = dict(drop_rate=0.2, duplicate_rate=0.1, seed=5)
    sides = [
        (PGeoNet(Inner(), PGeo(regions=regions, rtt_ms=rtt, seed=3).for_node(1),
                 chaos=PChaos(**chaos).for_node(1)), PIdentity, PFakePublic, PPacket),
        (RGeoNet(Inner(), RGeo(regions=regions, rtt_ms=rtt, seed=3).for_node(1),
                 chaos=RChaos(**chaos).for_node(1)), RIdentity, RFakePublic, RPacket),
    ]
    for net, ident, pub, pkt in sides:
        for k in range(40):
            dst = k % 8
            # no running loop: a delayed delivery goes out at once
            net.send([ident(dst, f"n-{dst}", pub(True))],
                     pkt(origin=1, level=k % 4, multisig=bytes([k]) * 3))
    (po, *_), (pt, *_) = sides
    assert po.values() == pt.values()
    assert po.values()["geoDelayed"] > 0
    assert [(ids, p.encode()) for ids, p in po.inner.sent] == \
        [(ids, p.encode()) for ids, p in pt.inner.sent]
    ho, ht = po.histograms()["delayMs"], pt.histograms()["delayMs"]
    assert (ho.count, ho.quantile(0.5), ho.quantile(0.99)) == \
        (ht.count, ht.quantile(0.5), ht.quantile(0.99))


def scenario_toml(mod, tmp_path, **scenario):
    cfg = mod.SimConfig(scheme="fake", scenario=mod.ScenarioParams(**scenario),
                        runs=[mod.RunConfig(nodes=8)])
    path = tmp_path / f"{mod.__name__.split('.')[0]}.toml"
    path.write_text(mod.dump_config(cfg))
    return path


@pytest.mark.parametrize(
    "scenario",
    [dict(planet="planet-5region", jitter_ms=3.0, geo_seed=7),
     dict(planet="planet-3region-fast", geo_seed=1),
     dict(regions=INLINE[0], rtt_ms=INLINE[1], jitter_ms=0.5, geo_seed=4)],
    ids=["planet-5region", "planet-3region-fast", "inline"],
)
def test_scenario_toml_resolves_to_the_same_planet(tmp_path, scenario):
    text = pconfig.dump_config(pconfig.load_config(str(scenario_toml(pconfig, tmp_path, **scenario))))
    assert text == rconfig.dump_config(rconfig.load_config(str(scenario_toml(rconfig, tmp_path, **scenario))))
    path = tmp_path / "both.toml"
    path.write_text(text)
    ours = pconfig.load_config(str(path)).scenario.geo_config()
    theirs = rconfig.load_config(str(path)).scenario.geo_config()
    assert (list(ours.regions), [list(r) for r in ours.rtt_ms], ours.jitter_ms, ours.seed) == \
        (list(theirs.regions), [list(r) for r in theirs.rtt_ms], theirs.jitter_ms, theirs.seed)


def test_geo_round_tags_every_node_span_with_its_region():
    """16 nodes on the 3-region fast planet through the port's harness: the
    round completes, and each node's pipeline spans carry its region, the
    one the planet places it in."""
    from handel_tpu_torch.core.test_harness import LocalCluster
    from handel_tpu_torch.core.trace import FlightRecorder

    regions, rtt = pplanets.planet_preset("planet-3region-fast")
    geo = PGeo(regions=regions, rtt_ms=rtt, jitter_ms=1.0, seed=7)
    rec = FlightRecorder(capacity=1 << 16)

    async def go():
        cluster = LocalCluster(16, geo=geo, recorder=rec)
        cluster.start()
        try:
            return await cluster.wait_complete_success(timeout=60)
        finally:
            cluster.stop()

    finals = asyncio.run(go())
    assert len(finals) == 16
    events = rec.export()["traceEvents"]
    tagged = [e for e in events if e.get("name") in ("send", "recv", "merge")]
    assert tagged
    for e in tagged:
        assert e["args"]["region"] == geo.region_of(e["tid"])
    assert {e["args"]["region"] for e in tagged} == set(regions)


def geo_cfg(mod):
    return mod.SimConfig(
        network="udp", scheme="fake", max_timeout_s=60.0,
        scenario=mod.ScenarioParams(planet="planet-3region-fast", jitter_ms=1.0, geo_seed=7),
        chaos=mod.ChaosConfig(drop_rate=0.02, seed=3),
        runs=[mod.RunConfig(nodes=12, processes=2)],
    )


def run_platform(platform_cls, cfg, workdir):
    async def go():
        return await platform_cls(cfg, str(workdir)).start_run(0)

    res = asyncio.run(go())
    if not res.ok:
        for out, err in res.outputs:
            print(out.decode(errors="replace"), err.decode(errors="replace"))
    return res


def test_geo_localhost_run_beside_reference(tmp_path):
    import csv

    res = run_platform(PPlatform, geo_cfg(pconfig), tmp_path / "port")
    ref = run_platform(RPlatform, geo_cfg(rconfig), tmp_path / "ref")
    assert res.ok and ref.ok
    rows = [list(csv.DictReader(open(r.csv_path)))[0] for r in (res, ref)]
    assert set(rows[0]) == set(rows[1])
    for row in rows:
        assert float(row["net_geoDelayed_sum"]) > 0
        assert not math.isnan(float(row["net_delayMs_p50"]))
