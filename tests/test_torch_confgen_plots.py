"""The port's experiment generator, evaluator strategies and plots
(handel_tpu_torch/sim/confgen.py, core/processing.py `Evaluator1`,
sim/plots.py) against the JAX package's.

Every confgen scenario dumps to the same TOML text in both packages, and
`generate` and the `confgen` subcommand write the same files (exact, byte
for byte). `Evaluator1` and `FifoProcessing` select the same batches in the
same order from the same seeded candidates, and `eval1` and `fifo` rounds
reach the threshold, through the harness and through the localhost
platform beside the reference (the same CSV columns). The plot functions
read the same rows, draw the same series and write the same file names;
`trace --plot` writes the wave from a traced run. Without `matplotlib` a
plot raises an ImportError naming it.
"""

import asyncio
import csv
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from handel_tpu.core import processing as rprocessing
from handel_tpu.sim import confgen as rconfgen
from handel_tpu.sim import config as rconfig
from handel_tpu.sim import plots as rplots
from handel_tpu_torch.core import processing as pprocessing
from handel_tpu_torch.sim import confgen as pconfgen
from handel_tpu_torch.sim import config as pconfig
from handel_tpu_torch.sim import plots as pplots

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))


# -- confgen ---------------------------------------------------------------


def test_scenario_tables_match():
    assert list(pconfgen.SCENARIOS) == list(rconfgen.SCENARIOS)
    assert pconfgen.NODE_SWEEP == rconfgen.NODE_SWEEP
    assert pconfgen.MAX_PROCESSES == rconfgen.MAX_PROCESSES
    for n in (1, 499, 500, 4000, 65536):
        assert pconfgen.default_processes(n) == rconfgen.default_processes(n)


@pytest.mark.parametrize("name", list(rconfgen.SCENARIOS))
def test_each_scenario_dumps_the_same_toml(name, tmp_path):
    text = pconfig.dump_config(pconfgen.SCENARIOS[name]())
    assert text == rconfig.dump_config(rconfgen.SCENARIOS[name]())
    path = tmp_path / f"{name}.toml"
    path.write_text(text)
    assert pconfig.dump_config(pconfig.load_config(str(path))) == \
        rconfig.dump_config(rconfig.load_config(str(path)))


def test_generate_and_the_subcommand_write_the_reference_files(tmp_path):
    ours = pconfgen.generate(str(tmp_path / "port"))
    theirs = rconfgen.generate(str(tmp_path / "ref"))
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        assert Path(a).read_text() == Path(b).read_text()
    out = subprocess.run(
        [sys.executable, "-m", "handel_tpu_torch.sim", "confgen", "--scenario", "geo",
         "--scenario", "evaluator", "--outdir", str(tmp_path / "cli")],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path / "cli" / "geo.toml"),
                                  str(tmp_path / "cli" / "evaluator.toml")]
    for name in ("geo", "evaluator"):
        assert (tmp_path / "cli" / f"{name}.toml").read_text() == \
            (tmp_path / "ref" / f"{name}.toml").read_text()


# -- evaluator strategies ---------------------------------------------------


def pipeline(pkg, cls_name, n, node, batch, evaluator):
    """One package's pipeline over the fake scheme for node `node` of `n`,
    with `Evaluator1` or the store as its evaluator; returns it, its
    partitioner and the list its publishes land in."""
    mods = {
        "port": ("handel_tpu_torch", pprocessing),
        "ref": ("handel_tpu", rprocessing),
    }
    root, proc_mod = mods[pkg]
    bs = __import__(f"{root}.core.bitset", fromlist=["x"])
    cr = __import__(f"{root}.core.crypto", fromlist=["x"])
    ident = __import__(f"{root}.core.identity", fromlist=["x"])
    part = __import__(f"{root}.core.partitioner", fromlist=["x"])
    st = __import__(f"{root}.core.store", fromlist=["x"])
    fk = __import__(f"{root}.models.fake", fromlist=["x"])
    reg = ident.ArrayRegistry([ident.Identity(i, f"n-{i}", fk.FakePublic(True)) for i in range(n)])
    p = part.BinomialPartitioner(node, reg)
    s = st.SignatureStore(p, bs.BitSet, fk.FakeConstructor())
    published = []

    def on_verified(sp):
        published.append((sp.origin, sp.level, sp.is_ind))
        s.store(sp)

    ev = proc_mod.Evaluator1() if evaluator == "eval1" else s
    proc = getattr(proc_mod, cls_name)(
        p, fk.FakeConstructor(), b"m", reg.public_keys(), ev, on_verified,
        batch_size=batch, max_pending=64,
    )

    def candidates(seed, count):
        rng = random.Random(seed)
        out = []
        for _ in range(count):
            lvl = rng.choice(p.levels())
            lo, hi = p.range_level(lvl)
            origin = rng.randrange(lo, hi)
            ind = rng.random() < 0.4
            idx = [origin - lo] if ind else sorted(rng.sample(range(hi - lo), rng.randrange(1, hi - lo + 1)))
            b = bs.BitSet(hi - lo)
            for i in idx:
                b.set(i, True)
            out.append(part.IncomingSig(origin, lvl, cr.MultiSignature(b, fk.FakeSignature(True)),
                                        is_ind=ind, mapped_index=idx[0] if ind else 0))
        return out

    return proc, candidates, published


@pytest.mark.parametrize("strategy", ["eval1", "fifo"])
@pytest.mark.parametrize("n, node, seed, batch", [(8, 3, 5, 2), (21, 0, 6, 4), (64, 33, 7, 8)])
def test_evaluator_strategies_give_the_same_verdict_order(strategy, n, node, seed, batch):
    """The same candidates in: the same batches out, in the same order, and
    the same publishes, for `Evaluator1` (everything scores 1) and for
    `FifoProcessing` (arrival order, no scoring)."""
    cls_name, ev = ("BatchProcessing", "eval1") if strategy == "eval1" else ("FifoProcessing", "store")
    sides = [pipeline(pkg, cls_name, n, node, batch, ev) for pkg in ("port", "ref")]
    seqs = [cands(seed, 3 * n) for _, cands, _ in sides]
    batches = 0
    for chunk in range(0, 3 * n, 16):
        for (proc, _, _), seq in zip(sides, seqs):
            for sp in seq[chunk:chunk + 16]:
                proc.add(sp)
        while True:
            picked = [proc._select_batch() for proc, _, _ in sides]
            shape = [[(sp.origin, sp.level, sp.is_ind, sp.ms.marshal()) for sp in b] for b in picked]
            assert shape[0] == shape[1]
            if not picked[0]:
                break
            batches += 1
            for (proc, _, _), b in zip(sides, picked):
                for sp in b:
                    proc.on_verified(sp)
                proc._dirty = True
    assert batches > 1
    assert sides[0][2] == sides[1][2]


@pytest.mark.parametrize("evaluator", ["store", "eval1", "fifo"])
def test_to_config_wires_the_reference_strategy(evaluator):
    ours = pconfig.HandelParams(evaluator=evaluator).to_config(5, seed=1)
    theirs = rconfig.HandelParams(evaluator=evaluator).to_config(5, seed=1)
    assert (ours.new_evaluator is None) == (theirs.new_evaluator is None)
    if evaluator == "fifo":
        assert ours.new_processing is pprocessing.FifoProcessing
        assert theirs.new_processing is rprocessing.FifoProcessing
    else:
        assert ours.new_processing is None and theirs.new_processing is None
    if evaluator == "eval1":
        assert type(ours.new_evaluator(None, None)).__name__ == "Evaluator1"


@pytest.mark.parametrize("evaluator", ["eval1", "fifo"])
def test_evaluator_rounds_reach_threshold_in_both_harnesses(evaluator):
    from handel_tpu.core.test_harness import LocalCluster as RCluster
    from handel_tpu.core.timeout import InfiniteTimeout as RInf
    from handel_tpu_torch.core.test_harness import LocalCluster as PCluster
    from handel_tpu_torch.core.timeout import InfiniteTimeout as PInf

    def factory(mod, inf):
        def make(i):
            c = mod.HandelParams(evaluator=evaluator).to_config(0, seed=1 + i)
            c.new_timeout = inf
            return c
        return make

    async def go(cluster):
        cluster.start()
        try:
            return await cluster.wait_complete_success(timeout=60)
        finally:
            cluster.stop()

    for cls, mod, inf in ((PCluster, pconfig, PInf), (RCluster, rconfig, RInf)):
        cluster = cls(32, threshold=30, config_factory=factory(mod, inf))
        finals = asyncio.run(go(cluster))
        assert len(finals) == 32
        assert all(ms.bitset.cardinality() >= 30 for ms in finals.values())


def test_evaluator_scenario_runs_through_both_platforms(tmp_path):
    """confgen's `evaluator` scenario, cut to 8 nodes on the fake scheme:
    its three runs (store, eval1, fifo) succeed through both localhost
    platforms with the same CSV columns."""
    from handel_tpu.sim.platform import run_simulation as r_run
    from handel_tpu_torch.sim.platform import run_simulation as p_run

    def cut(mod, confgen):
        cfg = confgen.scenario_evaluator(8)
        cfg.scheme, cfg.max_timeout_s = "fake", 60.0
        for r in cfg.runs:
            r.processes = 2
        return cfg

    headers = []
    for mod, confgen, run, sub in ((pconfig, pconfgen, p_run, "port"), (rconfig, rconfgen, r_run, "ref")):
        results = asyncio.run(run(cut(mod, confgen), str(tmp_path / sub)))
        assert [r.ok for r in results] == [True, True, True]
        headers.append([set(next(csv.reader(open(r.csv_path)))) for r in results])
    assert headers[0] == headers[1]


# -- plots -----------------------------------------------------------------

CSVS = {
    "handel": str(ROOT / "results" / "handel.csv"),
    "nsquare": str(ROOT / "results" / "nsquare.csv"),
    "gossipsub": str(ROOT / "results" / "gossipsub.csv"),
}
SWEEPS = {
    "period": {"period": str(ROOT / "results" / "sweeps_period.csv")},
    "timeout": {"timeout": str(ROOT / "results" / "sweeps_timeout.csv")},
    "updatecount": {"updatecount": str(ROOT / "results" / "sweeps_update_count.csv")},
    "batchplane": {"device": str(ROOT / "results" / "handel_128_device.csv"),
                   "device_1024": str(ROOT / "results" / "handel_1024_device.csv")},
}


@pytest.mark.parametrize("path", sorted(set(CSVS.values()) | {
    p for d in SWEEPS.values() for p in d.values()}), ids=os.path.basename)
def test_rows_and_series_match(path):
    rows = pplots.read_rows(path)
    assert rows == rplots.read_rows(path)
    cols = sorted({k for r in rows for k in r})
    for x in ("nodes", "failing", "period_ms", "timeout_ms", "update_count"):
        for y in cols[:40]:
            assert pplots._series(rows, x, y) == rplots._series(rows, x, y)


@pytest.mark.parametrize("kind", list(rplots.KINDS))
def test_each_plot_draws_the_same_series_and_file(kind, tmp_path, monkeypatch):
    assert list(pplots.KINDS) == list(rplots.KINDS)
    csvs = SWEEPS.get(kind, CSVS)
    drawn = {}
    for name, mod in (("port", pplots), ("ref", rplots)):
        calls = []
        real = mod._plot_xy
        monkeypatch.setattr(mod, "_plot_xy", lambda *a, _r=real, _c=calls, **k: (_c.append((a, k)), _r(*a, **k))[1])
        out = tmp_path / name / f"{kind}.png"
        out.parent.mkdir()
        assert mod.KINDS[kind](csvs, str(out)) == str(out)
        assert out.stat().st_size > 0
        drawn[name] = [(a[:1] + a[1:3], k) for a, k in calls]
    assert drawn["port"] == drawn["ref"]


def test_plots_cli_and_trace_timeline(tmp_path):
    for mod in (pplots, rplots):
        assert mod.main(["bogus"]) == 2
    out = tmp_path / "time.png"
    assert pplots.main(["time", str(out), CSVS["handel"], CSVS["nsquare"]]) == 0
    assert out.exists()
    wave = {1: (0.01, 0.02, 0.05), 2: (0.03, 0.05, 0.09), 3: (0.06, 0.1, 0.2)}
    for name, mod in (("port", pplots), ("ref", rplots)):
        assert mod.plot_trace_timeline(wave, str(tmp_path / f"{name}.png")) == str(tmp_path / f"{name}.png")
        with pytest.raises(ValueError, match="no level_complete"):
            mod.plot_trace_timeline({}, str(tmp_path / "empty.png"))


def test_trace_plot_writes_the_wave_of_a_traced_round(tmp_path):
    """`python -m handel_tpu_torch.sim trace <dir> --plot w.png` over a traced
    16-node round of the port's harness."""
    from handel_tpu_torch.core.test_harness import run_cluster
    from handel_tpu_torch.core.trace import FlightRecorder

    rec = FlightRecorder(capacity=1 << 16)
    asyncio.run(run_cluster(16, recorder=rec))
    trace_dir = tmp_path / "trace"
    trace_dir.mkdir()
    rec.dump(str(trace_dir / "trace_0.json"))
    png = tmp_path / "w.png"
    out = subprocess.run(
        [sys.executable, "-m", "handel_tpu_torch.sim", "trace", str(trace_dir), "--plot", str(png)],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert f"wave plot -> {png}" in out.stdout
    assert png.stat().st_size > 0


WITHOUT_MATPLOTLIB = r"""
import sys
sys.modules["matplotlib"] = None  # `import matplotlib` now raises
from handel_tpu_torch.sim import plots, trace_cli
rows = plots.read_rows(sys.argv[1])
assert rows
try:
    plots.plot_time_vs_nodes({"h": sys.argv[1]}, "x.png")
except ImportError as e:
    print("ImportError:", e)
"""


def test_without_matplotlib_a_plot_names_the_package(tmp_path):
    out = subprocess.run([sys.executable, "-c", WITHOUT_MATPLOTLIB, CSVS["handel"]],
                         cwd=tmp_path, env=ENV, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ImportError:") and "`matplotlib`" in out.stdout
