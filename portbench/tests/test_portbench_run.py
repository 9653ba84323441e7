"""Whole runs on the CPU, at a tiny size, past the harness's look for a
card: a cell added as files only (a configuration, a mix and a metric that
no existing file names) runs and proves correct, its last line has the
contract's schema, and with the timed path broken underneath `correct`
comes out false, once for each fault a one-chip verify cell can have and
once with the control's verdicts in the program's place.

Each run builds a 16-key BN254 engine on the CPU (a launch of 4 lanes takes
seconds there), so the file takes minutes. The card test at the end runs a
short cell on the card and skips here."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import control
from portbench.harness import cell_run, checks, spec

SEED = 2**34 + 77
CELL = "bn254-16.tiny"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with one configuration, one mix, one metric
    and one cell added as files and entries."""
    dst = tmp_path_factory.mktemp("bench")
    shutil.copytree(spec.ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load_benchmark()
    cfg = json.loads((spec.ROOT / "portbench/configs/bn254-4096.json").read_text())
    cfg.update(name="bn254-16", registry=16)
    (dst / "portbench/configs/bn254-16.json").write_text(json.dumps(cfg))
    mix = json.loads((spec.ROOT / "portbench/traffic/range.json").read_text())
    mix["params"].update(lanes_per_key=0.25, request_candidates=4, sessions=2, forged_every=4)
    (dst / "portbench/traffic/tiny.json").write_text(json.dumps(mix))
    (dst / "portbench/metrics/window.launches.py").write_text(
        "def read(r):\n    return r.close_i - r.open_i\n"
    )
    bench["configs"].append({"name": "bn254-16", "source": "https://example.org/tiny",
                             "file": "portbench/configs/bn254-16.json", "reduced": [],
                             "why": "a CPU-sized test"})
    bench["workloads"].append({"name": CELL, "config": "bn254-16", "traffic": "tiny",
                               "chips": 1, "why": "a CPU-sized test"})
    for m in bench["per_layer"]:
        m["workloads"].append(CELL)
    bench["per_layer"].append({"name": "window.launches", "unit": "launches",
                               "better": "higher", "source": "host_clock",
                               "layer": "service", "moves": "verify_rate",
                               "workloads": [CELL]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def run(root, trace=False, wrap=None, grace_s=20.0):
    cell = spec.load_cell(CELL, root)
    return cell_run.run_cell(cell, SEED, 1.0, trace, "cpu", time.perf_counter(),
                             grace_s=grace_s, wrap=wrap, root=root)


def test_a_cell_added_as_files_runs_and_its_last_line_has_the_schema(root):
    out = run(root, trace=True)
    assert out["correct"] is True, out["checks"]
    # the new metric is found by its name; the card's readers find nothing
    assert out["metrics"]["window.launches"]["value"] >= 1
    for name in ("service.fill", "service.verify_p95_ms", "engine.pack_ms", "engine.dispatch_ms"):
        assert out["metrics"][name]["value"] > 0
    assert out["metrics"]["service.fill"]["value"] == pytest.approx(100.0)
    for name in ("ops.kernels_per_launch", "kernels.b1_roofline", "device.idle"):
        assert name not in out["metrics"]
    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        checks.emit(out)
    line = json.loads(stdout.getvalue().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes",
                                   "busy_s", "window_s"}
    assert line["attempted"] > 0 and line["failed"] == 0
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    tail = stderr.getvalue().splitlines()[-len(checks.LIMITS):]
    assert tail == [f"check {k} 0 limit 0" for k in checks.LIMITS]


def flip_first(engine, pool, requests):
    """An answer altered where it is produced."""
    fetch = engine.fetch

    def wrong(handle):
        out = fetch(handle)
        out[0] = not out[0]
        return out

    engine.fetch = wrong


def half_left_out(engine, pool, requests):
    """Half of the batch left out: verdicts for the first half only."""
    fetch = engine.fetch
    engine.fetch = lambda handle: fetch(handle)[: max(1, handle[1] // 2)]


def state_unchanged(engine, pool, requests):
    """A launch that returns its verdicts' state unchanged (all accept)."""
    fetch = engine.fetch
    engine.fetch = lambda handle: [True] * len(fetch(handle))


@pytest.mark.parametrize(
    "fault", [flip_first, half_left_out, state_unchanged, control.control_in_place("bn254")],
    ids=["answer_altered", "half_batch_left_out", "state_unchanged", "control_in_place"],
)
def test_a_broken_timed_path_is_not_correct(root, fault):
    out = run(root, wrap=fault, grace_s=5.0)
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


def test_run_refuses_without_the_cards_the_cell_asks_for(root):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "bls12-381-2048.range",
         "--seed", str(SEED), "--seconds", "5", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900,
    )
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
