"""The port's sim entry point (handel_tpu_torch/sim/) against the JAX
package's (handel_tpu/sim/).

Both packages get the same inputs: allocation grids, registry CSVs written
by one and read by the other, every TOML config of the repo, the same
monitor measurements, and the same localhost runs, whose results CSVs must
carry the same columns. The port also runs its device scheme (`bn254-cuda`)
through the whole path on the CPU engine, refuses the card where there is
none, and names the ROADMAP item of every part it has not ported.
"""

import asyncio
import csv
import glob
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from handel_tpu.core.trace import LogHistogram as RHist
from handel_tpu.models.registry import is_device_scheme as r_is_device
from handel_tpu.sim import allocator as ralloc
from handel_tpu.sim import config as rconfig
from handel_tpu.sim import keys as rkeys
from handel_tpu.sim import monitor as rmon
from handel_tpu.sim import sync as rsync
from handel_tpu.sim.platform import LocalhostPlatform as RPlatform
from handel_tpu_torch.core.trace import LogHistogram as PHist
from handel_tpu_torch.models import registry as preg
from handel_tpu_torch.sim import allocator as palloc
from handel_tpu_torch.sim import config as pconfig
from handel_tpu_torch.sim import keys as pkeys
from handel_tpu_torch.sim import monitor as pmon
from handel_tpu_torch.sim import sync as psync
from handel_tpu_torch.sim.platform import LocalhostPlatform as PPlatform
from handel_tpu_torch.sim.platform import free_ports

ROOT = Path(__file__).resolve().parents[1]
TOMLS = sorted(glob.glob(str(ROOT / "results" / "*.toml")))


# -- allocation -----------------------------------------------------------


@pytest.mark.parametrize("name", ["round-robin", "random"])
@pytest.mark.parametrize(
    "nodes, procs, failing",
    [(1, 1, 0), (8, 2, 0), (16, 4, 3), (33, 5, 7), (128, 2, 8), (40, 8, 10), (257, 16, 100)],
)
def test_allocation_matches(name, nodes, procs, failing):
    slot = lambda s: (s.id, s.instance, s.process, s.active)  # noqa: E731
    want = ralloc.new_allocator(name).allocate(nodes, 1, procs, failing)
    got = palloc.new_allocator(name).allocate(nodes, 1, procs, failing)
    assert sorted(want) == sorted(got)
    assert [slot(got[i]) for i in sorted(got)] == [slot(want[i]) for i in sorted(want)]


def test_allocation_rejects_what_the_reference_rejects():
    for mod in (ralloc, palloc):
        with pytest.raises(ValueError, match="unknown allocator"):
            mod.new_allocator("bogus")


# -- the registry CSV, both ways ------------------------------------------


def schemes(name):
    from handel_tpu.models.registry import new_scheme as r_new

    return r_new(name), preg.new_scheme(name)


@pytest.mark.parametrize("name", ["fake", "bn254"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_registry_csv_reads_the_same_in_both_packages(tmp_path, name, writer):
    rs, ps = schemes(name)
    addrs = [f"127.0.0.1:{4000 + i}" for i in range(5)]
    w_keys, w_scheme = (rkeys, rs) if writer == "reference" else (pkeys, ps)
    records = w_keys.generate_nodes(w_scheme, addrs)
    path = str(tmp_path / "reg.csv")
    w_keys.write_registry_csv(path, records)
    # both packages generate the same keys for the same ids
    other = (pkeys, ps) if writer == "reference" else (rkeys, rs)
    assert [vars(r) for r in other[0].generate_nodes(other[1], addrs)] == [
        vars(r) for r in records
    ]
    text = Path(path).read_bytes()
    regs = {}
    for keys, scheme in ((rkeys, rs), (pkeys, ps)):
        back = keys.read_registry_csv(path)
        assert [vars(r) for r in back] == [vars(r) for r in records]
        reg = keys.registry_from_records(back, scheme)
        regs[keys] = (
            [reg.identity(i).address for i in range(reg.size())],
            [pk.marshal() for pk in reg.public_keys()],
            [keys.secret_of(r, scheme).marshal() for r in back],
        )
        # and writes it back byte for byte
        again = str(tmp_path / "again.csv")
        keys.write_registry_csv(again, back)
        assert Path(again).read_bytes() == text
    assert regs[rkeys] == regs[pkeys]
    assert regs[pkeys][0] == addrs


# -- the TOML format -------------------------------------------------------


@pytest.mark.parametrize("path", TOMLS, ids=lambda p: Path(p).name)
def test_every_repo_config_loads_and_dumps_the_same(path, tmp_path):
    want = rconfig.dump_config(rconfig.load_config(path))
    got = pconfig.dump_config(pconfig.load_config(path))
    assert got == want
    again = tmp_path / "again.toml"
    again.write_text(got)
    assert pconfig.dump_config(pconfig.load_config(str(again))) == got


def test_config_defaults_and_edits_dump_the_same(tmp_path):
    """Every section that only dumps when it differs from its defaults."""
    text = """
network = "tcp"
scheme = "bn254-cuda"
batch_size = 128
fp_backend = "rns"
[chaos]
drop_rate = 0.1
seed = 3
[service]
sessions = 4
tiers = "gold,bronze"
batch_check = "rlc"
[soak]
duration_s = 8.0
[load]
rate_sps = 2.5
model = "burst"
[federation]
kill_region = "us-east"
[alerts]
window_scale = 0.02
[scenario]
regions = ["a", "b"]
rtt_ms = [[0.0, 10.0], [10.0, 0.0]]
weight_profile = "pareto"
[swarm]
identities = 64
[[hosts]]
connect = "ssh:u@h"
device = true
[[runs]]
nodes = 12
failing = 2
[runs.adversaries]
flooder = 1
[runs.handel]
evaluator = "fifo"
"""
    path = tmp_path / "all.toml"
    path.write_text(text)
    assert pconfig.dump_config(pconfig.load_config(str(path))) == rconfig.dump_config(
        rconfig.load_config(str(path))
    )


@pytest.mark.parametrize(
    "text",
    ['fp_backend = "vpu"', '[service]\nbatch_check = "bogus"', '[load]\nmodel = "lunar"',
     '[chaos]\ndrop_rate = 2.0', '[alerts]\nwarn_x = 20.0'],
)
def test_config_rejects_what_the_reference_rejects(tmp_path, text):
    path = tmp_path / "bad.toml"
    path.write_text(text + "\n")
    for mod in (rconfig, pconfig):
        with pytest.raises(ValueError):
            mod.load_config(str(path))


def test_run_stats_extra_and_threshold_match():
    for nodes, thr in ((8, 0), (128, 120), (1000, 0)):
        r = rconfig.RunConfig(nodes=nodes, threshold=thr)
        p = pconfig.RunConfig(nodes=nodes, threshold=thr)
        assert p.resolved_threshold() == r.resolved_threshold()
        assert p.stats_extra(2) == r.stats_extra(2)
    hp = pconfig.HandelParams(period_ms=20.0, update_count=2, fast_path=3, timeout_ms=70.0)
    rp = rconfig.HandelParams(period_ms=20.0, update_count=2, fast_path=3, timeout_ms=70.0)
    pc, rc = hp.to_config(5, seed=9), rp.to_config(5, seed=9)
    for f in ("update_period", "update_count", "fast_path", "level_timeout", "contributions"):
        assert getattr(pc, f) == getattr(rc, f), f
    assert pc.rand.random() == rc.rand.random()


# -- monitor plane ---------------------------------------------------------


def hist_pair(seed: int, n: int):
    rng = np.random.default_rng(seed)
    r, p = RHist(), PHist()
    for v in rng.lognormal(-3.0, 2.0, n):
        r.add(float(v))
        p.add(float(v))
    return r, p


@pytest.mark.parametrize("seed, n", [(0, 0), (1, 1), (2, 50), (3, 5000)])
def test_log_histogram_sparse_form_round_trips(seed, n):
    r, p = hist_pair(seed, n)
    assert p.to_sparse() == r.to_sparse()
    back = PHist()
    back.merge_sparse(p.to_sparse())
    assert (back.counts, back.count, back.sum) == (p.counts, p.count, p.sum)
    if n:
        assert (back.lo, back.hi) == (p.lo, p.hi)
    # chunked as the sink sends it, reassembled as the master merges it
    rm, pm = RHist(), PHist()
    for payload in rmon._chunk_hist("sigs", "x", r):
        rm.merge_sparse(payload["hists"]["x"])
    chunks = list(pmon._chunk_hist("sigs", "x", p))
    assert chunks == list(rmon._chunk_hist("sigs", "x", r))
    for payload in chunks:
        pm.merge_sparse(payload["hists"]["x"])
    assert (pm.counts, pm.count) == (rm.counts, rm.count) == (p.counts, p.count)
    assert math.isclose(pm.sum, p.sum) and math.isclose(rm.sum, r.sum)
    for q in (0.5, 0.9, 0.99):
        assert (math.isnan(pm.quantile(q)) and math.isnan(rm.quantile(q))) or (
            pm.quantile(q) == rm.quantile(q)
        )


def test_merge_sparse_ignores_out_of_range_buckets():
    for cls in (RHist, PHist):
        h = cls()
        h.merge_sparse({"b": {"-1": 3, "999": 4, "5": 2}, "sum": 1.5, "lo": 0.1, "hi": 0.2})
        assert h.count == 2 and h.counts[5] == 2 and h.sum == 1.5


def test_chunked_values_match():
    vals = {f"key{i:03d}WithALongName": float(i) * 1.5 for i in range(300)}
    assert list(pmon._chunk_values("sigs", vals)) == list(rmon._chunk_values("sigs", vals))
    assert list(pmon._chunk_values("x", {})) == list(rmon._chunk_values("x", {}))


def feed_stats(mod, hist_mod, filt):
    stats = mod.Stats(
        extra={"run": 0.0, "nodes": 8.0},
        data_filter=mod.DataFilter(filt),
        expected=("sigen_wall", "never_sent"),
    )
    rng = np.random.default_rng(5)
    for i in range(40):
        stats.update("sigen_wall", float(rng.uniform(0.1, 3.0)))
        stats.update("net_sentPackets", float(i))
    stats.declare("gaugeKey", gauge=True)
    h = hist_mod()
    for v in rng.exponential(0.01, 300):
        h.add(float(v))
    for payload in mod._chunk_hist("sigs", "verifyLatencyS", h):
        for k, body in payload["hists"].items():
            stats.update_hist(f"sigs_{k}", body)
    return stats


@pytest.mark.parametrize("filt", [{}, {"sigen_wall": 90.0}])
def test_stats_columns_and_rows_match(filt, tmp_path):
    with pytest.warns(RuntimeWarning, match="never_sent"):
        r = feed_stats(rmon, RHist, filt)
        rrow = r.row()
    with pytest.warns(RuntimeWarning, match="never_sent"):
        p = feed_stats(pmon, PHist, filt)
        prow = p.row()
    assert p.columns() == r.columns()
    assert len(prow) == len(rrow)
    for a, b in zip(prow, rrow):
        assert (math.isnan(a) and math.isnan(b)) or a == pytest.approx(b, rel=1e-12)
    assert p.gauge_keys() == r.gauge_keys() == {"gaugeKey"}
    with pytest.warns(RuntimeWarning):
        p.write_csv(str(tmp_path / "p.csv"))
    with pytest.warns(RuntimeWarning):
        r.write_csv(str(tmp_path / "r.csv"))
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "r.csv").read_text()


def test_port_sink_feeds_the_reference_monitor_and_back():
    """The UDP JSON measure pipe is one format: each package's sink lands in
    the other's monitor with the same columns and values."""

    async def go(sink_mod, mon_mod, hist_mod):
        (port,) = free_ports(1)
        mon = mon_mod.Monitor(port, expected_keys=("sigen_wall",))
        await mon.start()
        sink = sink_mod.Sink(f"127.0.0.1:{port}")
        for v in (1.0, 3.0):
            sink.record("sigen", {"wall": v})
        sink.record("net", {f"k{i}": float(i) for i in range(200)})
        h = hist_mod()
        for v in (0.001, 0.01, 0.1):
            h.add(v)
        sink.record_histograms("sigs", {"levelCompleteS": h, "empty": hist_mod()})
        for _ in range(100):
            if len(mon.stats.columns()) >= 2 + 5 * 201 + 4:
                break
            await asyncio.sleep(0.01)
        mon.stop()
        sink.close()
        return mon.stats.columns(), mon.stats.row()

    a = asyncio.run(go(pmon, rmon, PHist))
    b = asyncio.run(go(rmon, pmon, RHist))
    assert a == b
    cols = dict(zip(*a))
    assert cols["sigen_wall_avg"] == 2.0
    assert cols["sigs_levelCompleteS_n"] == 3.0


def test_counter_io_treats_gauges_as_the_reference_does():
    class Rep:
        def __init__(self):
            self.v = {"sentPackets": 5.0, "hitRate": 0.5, "bestCardinality": 3.0}

        def values(self):
            return dict(self.v)

        def gauge_keys(self):
            return {"bestCardinality"}

    sent = {}

    class FakeSink:
        def record(self, name, values):
            sent.setdefault(name, []).append(values)

    for mod, name in ((rmon, "r"), (pmon, "p")):
        rep = Rep()
        io = mod.CounterIO(FakeSink(), name, rep)
        rep.v = {"sentPackets": 9.0, "hitRate": 0.75, "bestCardinality": 7.0}
        io.record()
    assert sent["p"] == sent["r"] == [{"sentPackets": 4.0, "hitRate": 0.75, "bestCardinality": 7.0}]


def test_report_plane_matches():
    from handel_tpu.core import report as rrep
    from handel_tpu_torch.core import report as prep

    out = {}
    for mod in (rrep, prep):
        t = mod.KernelTimer(lambda x: x + 1, name="launch")
        assert [t(i) for i in range(3)] == [1, 2, 3]
        agg = mod.ReportAggregator(launch=t)
        cc = mod.CurveCheckCounters()
        cc.add_g2(2.5)
        agg.add("subgroup", cc)
        vals = agg.values()
        out[mod] = (
            sorted(vals),
            {k: v for k, v in vals.items() if not k.endswith("Ms")},
            mod.diff_values({"a": 1.0}, {"a": 4.0, "b": 2.0}),
        )
    assert out[rrep] == out[prep]
    assert out[prep][1]["launch_launchCalls"] == 3.0


def test_kernel_timer_counts_every_call_from_many_threads():
    from concurrent.futures import ThreadPoolExecutor

    from handel_tpu_torch.core.report import KernelTimer

    t = KernelTimer(lambda: time.sleep(0.0005), name="dispatch")
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda _: t(), range(400)))
    v = t.values()
    assert v["dispatchCalls"] == 400.0
    assert v["dispatchTimeMs"] >= 400 * 0.5 and v["dispatchMaxMs"] >= 0.5


def test_sync_barriers_interoperate():
    """A port master releases reference slaves and the other way round."""

    async def go(master_mod, slave_mod):
        (port,) = free_ports(1)
        master = master_mod.SyncMaster(port, expected=3)
        await master.start()
        slaves = [slave_mod.SyncSlave(f"127.0.0.1:{port}", i) for i in range(3)]
        for s in slaves:
            await s.start()
        await asyncio.gather(
            master.wait_all(psync.STATE_START, 10.0),
            *(s.signal_and_wait(rsync.STATE_START, 10.0) for s in slaves),
        )
        master.stop()
        for s in slaves:
            s.stop()
        # the slave whose READY released the barrier got a direct, stamped ack
        return sum(s.clock_rtt < 10.0 for s in slaves)

    assert asyncio.run(go(psync, rsync)) >= 1
    assert asyncio.run(go(rsync, psync)) >= 1


# -- the node's reporters --------------------------------------------------


def test_handel_reporters_have_the_reference_keys():
    """The node's CounterIO/HistogramIO columns come from these keys."""
    from handel_tpu.core import test_harness as rh
    from handel_tpu_torch.core import test_harness as ph

    async def go(mod):
        c = mod.LocalCluster(8)
        c.start()
        await c.wait_complete_success(timeout=30)
        c.stop()
        h = c.handels[0]
        return set(h.values()), h.gauge_keys(), h.histograms()

    r, p = asyncio.run(go(rh)), asyncio.run(go(ph))
    assert p[0] == r[0]
    assert p[1] == r[1]
    assert set(p[2]) == set(r[2]) == {"levelCompleteS", "queueWaitS", "verifyLatencyS"}
    for k in ("levelCompleteS", "queueWaitS", "verifyLatencyS"):
        assert p[2][k].count > 0, k


# -- scheme table and device choice ----------------------------------------


REFERENCE_ALIASES = [
    "fake", "empty", "bn254", "bn256", "bn254-ref", "bn254-jax", "bn254-tpu", "bn256-tpu",
    "eddsa", "ed25519", "bls12-381", "bls12381", "bls12-381-jax", "bls12-381-tpu",
    "bls12381-jax",
]


@pytest.mark.parametrize("name", REFERENCE_ALIASES)
def test_scheme_table_matches_the_reference(name):
    assert preg.is_device_scheme(name) == r_is_device(name)
    if name.startswith("ed"):
        from handel_tpu_torch.models.eddsa import EdDSAScheme

        assert type(preg.new_scheme(name)) is EdDSAScheme
    elif name.startswith("bls"):
        from handel_tpu_torch.models.bls12_381 import BLS12381Scheme
        from handel_tpu_torch.models.bls12_381_torch import BLS12381TorchScheme

        if r_is_device(name):
            s = preg.new_scheme(name, batch_size=4, device="cpu", warmup=False)
            assert isinstance(s, BLS12381TorchScheme)
        else:
            assert type(preg.new_scheme(name)) is BLS12381Scheme


def test_device_names_select_the_port_engine():
    from handel_tpu_torch.models.bn254_torch import BN254TorchScheme

    for name in ("bn254-cuda", "bn256-cuda", "bn254-jax", "BN254-TPU", "bn256-tpu"):
        assert preg.is_device_scheme(name)
        s = preg.new_scheme(name, batch_size=4, device="cpu", warmup=False)
        assert isinstance(s, BN254TorchScheme)
        assert s.constructor.batch_size == 4
    with pytest.raises(ValueError, match="unknown signature scheme"):
        preg.new_scheme("bn254-gpu")


def test_device_from_env(monkeypatch):
    import torch

    from handel_tpu_torch.utils.torchenv import DEVICE_ENV, device_from_env

    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert device_from_env() == torch.device("cpu")
    monkeypatch.setenv(DEVICE_ENV, "mps")
    with pytest.raises(ValueError):
        device_from_env()
    monkeypatch.delenv(DEVICE_ENV)
    if torch.cuda.is_available():
        assert device_from_env().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            device_from_env()


# -- parts the node once refused -------------------------------------------


def unported(edit):
    cfg = pconfig.SimConfig(runs=[pconfig.RunConfig()])
    edit(cfg)
    return cfg


# once refused by the node, now ported: stake weights and departures, the
# comparison baselines, and a mesh of several devices
LIFTED = {
    "baseline": lambda c: setattr(c, "baseline", "gossipsub"),
    "churner": lambda c: setattr(c.runs[0].adversaries, "churner", 1),
    "mesh_devices": lambda c: setattr(c, "mesh_devices", 4),
    "weights": lambda c: setattr(c.scenario, "weight_profile", "linear"),
}


@pytest.mark.parametrize("part", sorted(LIFTED))
def test_lifted_options_pass_the_node_check(part, tmp_path):
    """The churner role, stake weights, the baselines and the mesh run in
    the port's node, which refuses none of them: the config dumps to the
    same text in both packages."""
    cfg = unported(LIFTED[part])
    text = pconfig.dump_config(cfg)
    path = tmp_path / "lifted.toml"
    path.write_text(text)
    assert rconfig.dump_config(rconfig.load_config(str(path))) == text


def test_service_batch_check_rlc_is_ignored_by_the_node_as_by_the_reference(tmp_path):
    """A config with `[service] batch_check = "rlc"` runs: the node ignores
    `[service]` (the reference's node builds its verifier without it), the
    config dumps to the same text in both packages, and the scheme the node
    builds checks per candidate."""
    cfg = unported(lambda c: None)
    cfg.scheme = "bn254-cuda"
    cfg.service.sessions = 2  # [service] dumps only with sessions
    cfg.service.batch_check = "rlc"
    text = pconfig.dump_config(cfg)
    assert 'batch_check = "rlc"' in text
    path = tmp_path / "rlc.toml"
    path.write_text(text)
    assert rconfig.dump_config(rconfig.load_config(str(path))) == text
    assert pconfig.dump_config(pconfig.load_config(str(path))) == text
    # the node's scheme, built as sim/node.py builds it
    scheme = preg.new_scheme(cfg.scheme, batch_size=cfg.batch_size, fp_backend=cfg.fp_backend,
                             rns_resident=None, device="cpu")
    assert scheme.constructor.batch_check == "per_candidate"


@pytest.mark.parametrize("profile", ["count", "linear", "pareto", "split"])
def test_scenario_make_weights_matches_the_reference(profile):
    """`ScenarioParams.make_weights` (a refusal until stake weights were
    ported) gives the reference's weights float for float, and the same
    weighted threshold."""
    ours = pconfig.ScenarioParams(weight_profile=profile, weight_seed=7)
    theirs = rconfig.ScenarioParams(weight_profile=profile, weight_seed=7)
    w = ours.make_weights(32)
    assert w == theirs.make_weights(32)
    assert ours.weight_threshold(17, 32, w) == theirs.weight_threshold(17, 32, w)


@pytest.mark.parametrize("sub", ["soak", "load", "scenario", "swarm"])
def test_ported_subcommands_parse_their_own_arguments(sub, monkeypatch, capsys):
    """`soak`, `load`, `scenario` and `swarm` are no longer refused: each
    parses its own arguments, as the reference's does (an unknown argument
    is an argparse error, exit 2, naming the subcommand's program)."""
    from handel_tpu_torch.sim.__main__ import main

    monkeypatch.setattr(sys, "argv", ["sim", sub, "x.toml", "--no-such-flag"])
    with pytest.raises(SystemExit) as e:
        main()
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"handel_tpu_torch.sim {sub}" in err and "ROADMAP" not in err


# -- localhost runs --------------------------------------------------------


def run_platform(platform_cls, cfg, workdir):
    async def go():
        return await platform_cls(cfg, str(workdir)).start_run(0)

    res = asyncio.run(go())
    if not res.ok:
        for out, err in res.outputs:
            print(out.decode(errors="replace"))
            print(err.decode(errors="replace"))
    return res


def header_and_row(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], dict(zip(rows[0], map(float, rows[1])))


@pytest.mark.parametrize(
    "scheme, nodes, processes, failing",
    [("fake", 8, 2, 0), ("fake", 16, 4, 3), ("bn254", 4, 2, 0)],
)
def test_localhost_platform_beside_reference(tmp_path, scheme, nodes, processes, failing):
    """Twins of tests/test_sim.py's test_localhost_platform and
    test_localhost_platform_bn254_real_crypto: real processes, UDP, barrier,
    monitor, through the port; the results CSV has the reference's columns."""
    threshold = (nodes - failing) // 2 + 1 if scheme == "fake" else 3

    def cfg(mod):
        return mod.SimConfig(
            network="udp", scheme=scheme, max_timeout_s=120.0,
            runs=[mod.RunConfig(nodes=nodes, threshold=threshold, failing=failing,
                                processes=processes)],
        )

    res = run_platform(PPlatform, cfg(pconfig), tmp_path / "port")
    assert res.ok
    ref = run_platform(RPlatform, cfg(rconfig), tmp_path / "ref")
    assert ref.ok
    header, row = header_and_row(res.csv_path)
    rheader, rrow = header_and_row(ref.csv_path)
    assert set(header) == set(rheader)
    assert "sigen_wall_avg" in header and any("net_sentBytes" in h for h in header)
    for col in ("sigs_queueWaitS_p50", "sigs_verifyLatencyS_p99", "sigs_levelCompleteS_n"):
        assert col in header, col
    assert row["nodes"] == rrow["nodes"] == nodes
    assert row["sigen_wall_avg"] > 0
    # every active node reported once (the CSV keeps 6 digits); each
    # process left its output
    assert row["sigen_wall_sum"] / row["sigen_wall_avg"] == pytest.approx(nodes - failing, rel=1e-4)
    outs = sorted(os.listdir(tmp_path / "port"))
    assert [f"node_0_{p}.out" in outs for p in range(processes)] == [True] * processes


def test_localhost_bn254_cuda_on_the_cpu_engine(tmp_path, monkeypatch):
    """The device scheme through the whole path, on the CPU engine: one
    shared verifier, its launches and the launch timers on the CSV."""
    monkeypatch.setenv("HANDEL_TORCH_DEVICE", "cpu")
    cfg = pconfig.SimConfig(
        network="udp", scheme="bn254-cuda", shared_verifier=True, batch_size=4,
        max_timeout_s=600.0, runs=[pconfig.RunConfig(nodes=4, threshold=3, processes=1)],
    )
    t0 = time.perf_counter()
    res = run_platform(PPlatform, cfg, tmp_path)
    assert res.ok, res.returncodes
    assert time.perf_counter() - t0 < 300
    header, row = header_and_row(res.csv_path)
    assert row["device_verifier_verifierLaunches_sum"] >= 1
    assert row["device_verifier_verifierCandidates_sum"] > 0
    assert row["device_verifier_failoverBatches_sum"] == 0
    assert row["device_dispatch_dispatchCalls_sum"] == row["device_verifier_verifierLaunches_sum"]
    assert row["device_subgroup_g2SubgroupChecks_sum"] >= 4
    assert any(h.startswith("device_launch_launchTimeMs") for h in header)
    # at 4 nodes every merge group is under the device combine's 4 points
    assert row["sigs_combineDeviceGroups_sum"] == 0
    assert row["sigs_combineHostGroups_sum"] > 0
    out = (tmp_path / "node_0_0.out").read_text()
    assert "node process finished OK" in out
    assert 'node process kernels: {"device": "cpu"' in out
    (kern,) = [json.loads(ln.split(": ", 1)[1]) for ln in out.splitlines()
               if ln.startswith("node process kernels: ")]
    assert kern["verifier_launches"] == row["device_verifier_verifierLaunches_sum"]


def test_localhost_bn254_cuda_on_a_two_shard_cpu_mesh(tmp_path, monkeypatch):
    """`mesh_devices = 2` on the device scheme: each node process builds its
    engine over two shards of the CPU (HANDEL_TORCH_DEVICE=cpu), as the
    reference's node builds its scheme over two forced host devices; the
    round completes and the shared verifier's launches ran over the mesh."""
    monkeypatch.setenv("HANDEL_TORCH_DEVICE", "cpu")
    cfg = pconfig.SimConfig(
        network="udp", scheme="bn254-cuda", shared_verifier=True, batch_size=4,
        mesh_devices=2, max_timeout_s=600.0,
        runs=[pconfig.RunConfig(nodes=4, threshold=3, processes=1)],
    )
    res = run_platform(PPlatform, cfg, tmp_path)
    assert res.ok, res.returncodes
    _header, row = header_and_row(res.csv_path)
    assert row["device_verifier_verifierLaunches_sum"] >= 1
    assert row["device_verifier_failoverBatches_sum"] == 0
    out = (tmp_path / "node_0_0.out").read_text()
    assert "node process finished OK" in out
    (kern,) = [json.loads(ln.split(": ", 1)[1]) for ln in out.splitlines()
               if ln.startswith("node process kernels: ")]
    # the warmup's launch and every verifier launch rode the mesh
    assert kern["mesh"] == {"devices": 2, "launches": kern["verifier_launches"] + 1}


def test_device_scheme_without_a_card_fails_without_falling_back(tmp_path, monkeypatch):
    """HANDEL_TORCH_DEVICE unset on a host without CUDA: the platform refuses
    before it spawns, and a node process started by hand exits non-zero with
    resolve_device's error. Neither runs on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    monkeypatch.delenv("HANDEL_TORCH_DEVICE", raising=False)
    cfg = pconfig.SimConfig(scheme="bn254-cuda", shared_verifier=True, batch_size=4,
                            runs=[pconfig.RunConfig(nodes=2, processes=1)])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run_platform(PPlatform, cfg, tmp_path / "plat")

    cfg_path = tmp_path / "sim.toml"
    cfg_path.write_text(pconfig.dump_config(cfg))
    reg = tmp_path / "reg.csv"
    pkeys.write_registry_csv(
        str(reg), pkeys.generate_nodes(preg.new_scheme("bn254"), ["127.0.0.1:1", "127.0.0.1:2"])
    )
    env = {k: v for k, v in os.environ.items() if k != "HANDEL_TORCH_DEVICE"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-m", "handel_tpu_torch.sim.node", "--config", str(cfg_path),
         "--registry", str(reg), "--master", "127.0.0.1:1", "--ids", "0,1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "finished OK" not in out.stdout


def test_a_failing_node_process_fails_the_run_at_once(tmp_path):
    """A node that exits non-zero (here: an evaluator name no node knows,
    refused by `HandelParams.to_config` in the node) ends the run without
    waiting out max_timeout_s."""
    cfg = pconfig.SimConfig(
        scheme="fake", max_timeout_s=60.0,
        runs=[pconfig.RunConfig(nodes=4, processes=2,
                                handel=pconfig.HandelParams(evaluator="bogus"))],
    )
    t0 = time.perf_counter()
    res = run_platform(PPlatform, cfg, tmp_path)
    assert not res.ok
    assert time.perf_counter() - t0 < 30
    assert all(rc != 0 for rc in res.returncodes)
    # the first process to fail ends the run; the other may be killed first
    errs = [(tmp_path / f"node_0_{p}.err").read_text() for p in range(2)]
    assert any("unknown evaluator 'bogus'" in e for e in errs)


def test_sim_cli_runs_a_config_and_prints_the_reference_lines(tmp_path):
    cfg_path = tmp_path / "c.toml"
    cfg_path.write_text(
        'network = "tcp"\nscheme = "fake"\nmax_timeout_s = 60.0\n'
        "[[runs]]\nnodes = 6\nthreshold = 4\nprocesses = 2\n"
        "[[runs]]\nnodes = 5\nthreshold = 3\nprocesses = 1\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "handel_tpu_torch.sim", "--config", str(cfg_path),
         "--workdir", str(tmp_path / "w")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines == [
        f"run 0: success -> {tmp_path / 'w' / 'results_0.csv'}",
        f"run 1: success -> {tmp_path / 'w' / 'results_1.csv'}",
    ]
    _, row = header_and_row(tmp_path / "w" / "results_1.csv")
    assert row["nodes"] == 5 and row["run"] == 1


# -- adversaries, chaos, tracing, metrics and the verifier RPC -------------


def adversarial_cfg(mod, scheme: str, nodes: int, threshold: int):
    return mod.SimConfig(
        network="udp", scheme=scheme, max_timeout_s=120.0, trace=True, metrics=True,
        chaos=mod.ChaosConfig(drop_rate=0.10, corrupt_rate=0.05, duplicate_rate=0.05, seed=99),
        runs=[mod.RunConfig(nodes=nodes, threshold=threshold, processes=2,
                            adversaries=mod.AdversaryParams(invalid_signer=1, stale_replayer=1,
                                                            flooder=1, flood_pps=100.0),
                            handel=mod.HandelParams(period_ms=100.0, timeout_ms=200.0))],
    )


@pytest.mark.parametrize("scheme, nodes, threshold", [("bn254", 8, 4), ("fake", 16, 9)])
def test_adversarial_traced_metrics_run_beside_reference(tmp_path, scheme, nodes, threshold):
    """A small adversarial, chaos, traced and metrics localhost run through
    both platforms: `success`, the same CSV columns, the byzantine cohort
    and chaos on the monitor plane, one trace per process that the trace
    CLI reads, and the metrics plan written."""
    from handel_tpu_torch.sim import trace_cli

    res = run_platform(PPlatform, adversarial_cfg(pconfig, scheme, nodes, threshold),
                       tmp_path / "port")
    assert res.ok
    ref = run_platform(RPlatform, adversarial_cfg(rconfig, scheme, nodes, threshold),
                       tmp_path / "ref")
    assert ref.ok
    header, row = header_and_row(res.csv_path)
    rheader, _ = header_and_row(ref.csv_path)
    assert set(header) == set(rheader)
    assert row["adversaries"] == 3.0
    assert row["net_chaosDropped_sum"] > 0
    assert row["sigs_advFloodedCt_sum"] > 0 and row["sigs_advReplayedCt_sum"] >= 0
    assert sorted(os.listdir(res.trace_dir)) == ["trace_0.json", "trace_1.json"]
    report = trace_cli.stream_report([res.trace_dir])
    assert report["files"] == 2 and report["critical_path"] is not None
    ports = json.loads((tmp_path / "port" / "metrics_ports.json").read_text())
    assert sorted(ports["addresses"]) == ["0", "1"]


class ScriptedLoss:
    """A node's transport that loses the first packet it sends to each
    (destination, level) in `lost`, as chaos did in the stalled run."""

    def __init__(self, inner, lost):
        self.inner, self.lost = inner, set(lost)

    def send(self, idents, packet):
        keep = [i for i in idents if (i.id, packet.level) not in self.lost]
        self.lost -= {(i.id, packet.level) for i in idents}
        if keep:
            self.inner.send(keep, packet)

    def register_listener(self, listener):
        self.inner.register_listener(listener)

    def values(self):
        return {}

    def stop(self):
        pass


def test_a_finished_process_serves_the_fleet_until_the_end_barrier():
    """The stalled run of ROADMAP §C1, scripted on a virtual clock: the
    adversarial config's 8 nodes (threshold 4, flooder 5, stale replayer 6,
    invalid signer 7) as two processes, ids 0, 2, 4, 6 and 1, 3, 5, 7,
    with the two packets the chaos plane lost there: node 2's level-1
    packet to node 3 and its level-2 packet to node 1. Process A's honest
    nodes finish first. Node 1 still needs one contribution, which node 4
    sends when its level 3 starts; a process that stopped its nodes as
    soon as its own were done (the reference, handel_tpu/sim/node.py:466)
    leaves node 1 at 3/4 for good. `serve_until_end` keeps them in the
    protocol until the END barrier, and every honest node finishes."""
    from handel_tpu_torch.core.config import Config
    from handel_tpu_torch.core.test_harness import LocalCluster
    from handel_tpu_torch.sim.node import serve_until_end
    from test_torch_protocol import run_on_virtual_clock

    def config(i):
        c = Config()
        c.update_period, c.level_timeout = 0.1, 0.2  # the config's period and timeout
        c.rand = __import__("random").Random(i)
        return c

    async def go():
        cluster = LocalCluster(8, threshold=4, config_factory=config, adversaries={
            5: "flooder", 6: "stale_replayer", 7: "invalid_signer"})
        nodes = {**cluster.handels, **cluster.adversaries}
        for nid, h in nodes.items():
            h.net = ScriptedLoss(h.net, [(3, 1), (1, 2)] if nid == 2 else [])
        arrived, released = [], asyncio.Event()

        async def end_barrier():
            arrived.append(1)
            if len(arrived) == 2:
                released.set()
            await released.wait()

        async def process(ids):
            handels = [(nid, nodes[nid], nodes[nid].net) for nid in ids]
            return await serve_until_end(handels, 4, 30.0, lambda finals: None, end_barrier)

        for h in nodes.values():
            h.start()
        return await asyncio.gather(process([0, 2, 4, 6]), process([1, 3, 5, 7]))

    finals_a, finals_b = run_on_virtual_clock(go())
    assert len(finals_a) == 3 and len(finals_b) == 2  # honest 0, 2, 4 and 1, 3
    assert all(ms.bitset.cardinality() >= 4 for ms in finals_a + finals_b)


class FakeRegistryDevice:
    """An engine that holds its registry, as a card's does: the verdict of
    each fake candidate is its signature's validity."""

    batch_size = 16

    def dispatch(self, msg, reqs):
        return [sig.valid for _bs, sig in reqs]

    def fetch(self, handle):
        return handle


def test_node_verifies_through_a_verifier_server(tmp_path):
    """Two node processes without an engine (`--verifier`) verify every
    candidate through one VerifierServer in front of a shared service: the
    run finishes OK and the server served their requests."""
    from handel_tpu_torch.models.fake import FakeConstructor, FakeScheme
    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
    from handel_tpu_torch.parallel.rpc_verifier import VerifierServer

    nodes = 8
    cfg = pconfig.SimConfig(network="udp", scheme="fake", max_timeout_s=60.0,
                            runs=[pconfig.RunConfig(nodes=nodes, threshold=5, processes=2)])
    cfg_path = tmp_path / "sim.toml"
    cfg_path.write_text(pconfig.dump_config(cfg))
    ports = free_ports(nodes + 1)
    reg = tmp_path / "reg.csv"
    pkeys.write_registry_csv(
        str(reg), pkeys.generate_nodes(FakeScheme(), [f"127.0.0.1:{p}" for p in ports[:nodes]]))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))

    async def go():
        service = BatchVerifierService(FakeRegistryDevice(), fallback=None, max_delay_ms=1.0)
        server = VerifierServer(service, FakeConstructor(), host="127.0.0.1")
        await server.start()
        sync = psync.SyncMaster(ports[nodes], nodes)
        await sync.start()
        procs = [await asyncio.create_subprocess_exec(
            sys.executable, "-m", "handel_tpu_torch.sim.node", "--config", str(cfg_path),
            "--registry", str(reg), "--master", f"127.0.0.1:{ports[nodes]}",
            "--ids", ",".join(str(i) for i in range(p, nodes, 2)),
            "--verifier", f"127.0.0.1:{server.port}",
            cwd=str(ROOT), env=env, stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE) for p in range(2)]
        try:
            await sync.wait_all(psync.STATE_START, 60)
            await sync.wait_all(psync.STATE_END, 60)
            outs = await asyncio.gather(*(p.communicate() for p in procs))
        finally:
            for p in procs:
                if p.returncode is None:
                    p.kill()
            sync.stop()
            server.stop()
            service.stop()
        return outs, [p.returncode for p in procs], server.values(), service.values()

    outs, rcs, served, svc = asyncio.run(go())
    assert rcs == [0, 0], [e.decode()[-2000:] for _, e in outs]
    assert all(b"node process finished OK" in out for out, _ in outs)
    assert served["rpcServedRequests"] > 0 and served["rpcServeErrors"] == 0
    assert svc["verifierLaunches"] >= 1 and svc["failoverBatches"] == 0


def test_capture_merges_every_run_like_the_reference(tmp_path):
    """The port's counterpart of scripts/capture.py runs a fake-scheme TOML's
    two [[runs]] and merges their rows into one CSV, byte for byte as the
    reference's merge_csvs merges the same per-run files."""
    import importlib.util

    from handel_tpu_torch.scripts import capture

    cfg = pconfig.SimConfig(
        network="udp", scheme="fake", max_timeout_s=30.0,
        runs=[pconfig.RunConfig(nodes=8, threshold=8, processes=1),
              pconfig.RunConfig(nodes=6, threshold=5, processes=2)],
    )
    toml = tmp_path / "c.toml"
    toml.write_text(pconfig.dump_config(cfg))
    out = tmp_path / "out.csv"
    assert capture.main([str(out), str(toml)]) == 0
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    assert [(r["nodes"], r["threshold"]) for r in rows] == [("8", "8"), ("6", "5")]
    parts = sorted(glob.glob(str(tmp_path / ".work" / "results_*.csv")))
    assert len(parts) == 2
    spec = importlib.util.spec_from_file_location("ref_capture", ROOT / "scripts" / "capture.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    assert capture.merge_csvs(parts, str(ours)) == ref.merge_csvs(parts, str(theirs)) == 2
    assert ours.read_bytes() == theirs.read_bytes()
