"""The port's live dashboard (handel_tpu_torch/sim/watch_cli.py, `python -m
handel_tpu_torch.sim watch`) against the JAX package's.

Over the same exposition text both packages parse the same families, build
the same dashboard model and render the same frame, character for
character (exact): the reference's captured snapshot of a watched 16-node
run, seeded synthetic texts that reach every row (sessions, federation,
fleets, alerts, the verifier and its breakers, lifecycle), and the
exposition of a live port cluster.
Endpoint discovery and scraping agree, and the `watch` subcommand launches
a run, renders it and snapshots both node processes' endpoints.
"""

import asyncio
import os
import random
import re
import subprocess
import sys
from pathlib import Path

import pytest

from handel_tpu.core.metrics import parse_exposition as r_parse
from handel_tpu.sim import watch_cli as rwatch
from handel_tpu_torch.core.metrics import parse_exposition as p_parse
from handel_tpu_torch.sim import watch_cli as pwatch

ROOT = Path(__file__).resolve().parents[1]
SNAPSHOT = ROOT / "results" / "handel_watch_16_metrics.txt"
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))


def endpoint_texts(snapshot: str) -> list[str]:
    """Each endpoint's raw /metrics text out of a `--snapshot` file."""
    return [t for t in re.split(r"^# scrape http://\S+/metrics\n", snapshot, flags=re.M) if t.strip()]


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    """The frame's header carries the time of day: one for both packages."""
    import time

    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:00:00")


def frames(texts: list[str], ticks=(1, 2, 7)):
    """(model, frames) of each package over the same texts."""
    out = []
    for parse, watch in ((p_parse, pwatch), (r_parse, rwatch)):
        scrapes = [parse(t) for t in texts]
        model = watch.aggregate(scrapes)
        eps = [f"127.0.0.1:{9100 + i}" for i in range(len(texts))]
        out.append((model, [watch.render(model, eps, len(scrapes), t) for t in ticks]))
    return out


def test_captured_snapshot_renders_alike():
    texts = endpoint_texts(SNAPSHOT.read_text())
    assert len(texts) == 2
    (m_ours, f_ours), (m_theirs, f_theirs) = frames(texts)
    assert m_ours == m_theirs
    assert f_ours == f_theirs
    assert m_ours["nodes"] == 16
    assert "aggregation wave (16 nodes reporting)" in f_ours[0]


# every family the dashboard reads, by the label its rows key on
LABELS = {
    "handel_service_": "session",
    "handel_device_breaker_state": "device",
    "handel_federation_region_healthy": "region",
    "handel_federation_spill": "region",
    "handel_fleet_host_up": "host",
    "handel_alerts_alert_state": "rule",
    "handel_alerts_burn": "rule",
    "handel_sigs_": "node",
    "handel_net_": "node",
    "handel_penalty_": "node",
}


def synthetic_text(seed: int) -> str:
    """A seeded exposition over every gauge family watch_cli reads."""
    rng = random.Random(seed)
    names = sorted(set(re.findall(r'"(handel_[a-z0-9_]+)"', Path(rwatch.__file__).read_text())))
    lines = []
    for name in names:
        if name.endswith(("_s",)) and name.startswith("handel_sigs_"):
            continue  # histograms: the snapshot case covers them
        label = next((lb for pre, lb in LABELS.items() if name.startswith(pre)), None)
        lines.append(f"# TYPE {name} gauge")
        keys = [None] if label is None else [f"{label[0]}{i}" for i in range(rng.randrange(1, 4))]
        for k in keys:
            value = rng.choice([0.0, 1.0, 0.5, round(rng.uniform(0, 500), 3), float(rng.randrange(100))])
            lbl = "" if k is None else f'{{{label}="{k}"}}'
            lines.append(f"{name}{lbl} {value}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(6))
def test_every_row_renders_alike_over_seeded_texts(seed):
    text = synthetic_text(seed)
    assert p_parse(text) == r_parse(text)
    (m_ours, f_ours), (m_theirs, f_theirs) = frames([text, synthetic_text(seed + 100)])
    assert m_ours == m_theirs
    assert f_ours == f_theirs
    for row in ("sessions", "federation", "fleet", "alerts", "verifier", "breakers",
                "lifecycle", "penalties", "network", "tracing"):
        assert f"\n{row} " in f_ours[0]


def test_a_live_port_cluster_renders_alike():
    """The exposition of a 16-node port cluster after its round, scraped
    over HTTP by both packages' `scrape`."""
    from handel_tpu_torch.core.test_harness import LocalCluster

    async def go():
        cluster = LocalCluster(16, metrics_port=0)
        cluster.start()
        try:
            await cluster.wait_complete_success(timeout=60)
            addr = cluster.metrics_server.address
            loop = asyncio.get_running_loop()
            got = [await loop.run_in_executor(None, w.scrape, addr) for w in (pwatch, rwatch)]
            return addr, got
        finally:
            cluster.stop()

    addr, ((fams_o, raw_o), (fams_t, raw_t)) = asyncio.run(go())
    assert fams_o == p_parse(raw_o) and fams_t == r_parse(raw_t)
    (m_ours, f_ours), (m_theirs, f_theirs) = frames([raw_o])
    assert m_ours == m_theirs and f_ours == f_theirs
    assert m_ours["nodes"] == 16
    # a closed endpoint reads as down in both
    assert pwatch.scrape(addr) is None and rwatch.scrape(addr) is None


def test_endpoint_discovery_alike(tmp_path):
    import json

    (tmp_path / "metrics_ports.json").write_text(
        json.dumps({"run": 0, "addresses": {"0": "127.0.0.1:9100", "1": "127.0.0.1:9101"}}))
    (tmp_path / "metrics_5.addr").write_text("127.0.0.1:9102\n")
    (tmp_path / "metrics_6.addr").write_text("127.0.0.1:9100\n")  # a duplicate
    assert pwatch.discover_endpoints(str(tmp_path)) == rwatch.discover_endpoints(str(tmp_path)) == [
        "127.0.0.1:9100", "127.0.0.1:9101", "127.0.0.1:9102"]
    assert pwatch.discover_endpoints(str(tmp_path / "none")) == []


def test_attach_to_a_dead_run_stops_and_renders_nothing(tmp_path):
    import io

    (tmp_path / "metrics_0.addr").write_text("127.0.0.1:9\n")
    out = io.StringIO()
    assert pwatch.watch_loop(str(tmp_path), 0.01, done=None, out=out) == 0
    assert out.getvalue() == ""


def test_watch_subcommand_launches_a_run_and_snapshots_both_endpoints(tmp_path):
    """results/handel_watch_16.toml on the fake scheme (16 nodes, two node
    processes): the run succeeds, the dashboard rendered, and the snapshot
    holds both endpoints' families."""
    text = (ROOT / "results" / "handel_watch_16.toml").read_text()
    cfg = tmp_path / "watch.toml"
    cfg.write_text(text.replace('scheme = "bn254"', 'scheme = "fake"'))
    snap = tmp_path / "snap.txt"
    out = subprocess.run(
        [sys.executable, "-m", "handel_tpu_torch.sim", "watch", str(cfg), "--workdir",
         str(tmp_path / "w"), "--interval", "0.25", "--snapshot", str(snap), "--max-seconds", "60"],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "run 0: success" in out.stdout
    assert "aggregation wave" in out.stdout
    texts = endpoint_texts(snap.read_text())
    assert len(texts) == 2 and "(2 endpoints)" in out.stderr
    model = pwatch.aggregate([p_parse(t) for t in texts])
    assert model["nodes"] == 16
