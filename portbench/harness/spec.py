"""The benchmark's data, found by name.

`BENCHMARK.json` at the root of the checkout names the cells; everything
that belongs to one configuration, one traffic mix or one per-layer metric
sits in a file of its own under `portbench/`, found by that name:

  configs/<config>.json    a configuration (sizes, engine, source), named
                           by BENCHMARK.json's `file`
  traffic/<mix>.json       a traffic mix: {"generator": <module>, "params"}
                           with the generator at traffic/<module>.py
  metrics/<metric>.py      a per-layer metric's reader: read(readings)

A later change adds a configuration, a mix, a cell or a metric by adding
files and entries; no file here names any of them. Every function takes
the checkout's root, so a test can point it at a copy.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclass(frozen=True)
class Cell:
    """One workload of BENCHMARK.json, with its configuration and mix
    loaded and the metrics that apply to it."""

    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload called `name`, its configuration and its traffic mix."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=json.loads((root / configs[w["config"]]["file"]).read_text()),
        mix=load_mix(w["traffic"], root),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_mix(name: str, root: Path = ROOT) -> dict:
    mix = json.loads((root / "portbench" / "traffic" / f"{name}.json").read_text())
    mix["name"] = name
    return mix


def _module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[label] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def generator(mix: dict, root: Path = ROOT):
    """The mix's generator module (traffic/<generator>.py)."""
    gen = mix["generator"]
    return _module(root / "portbench" / "traffic" / f"{gen}.py", f"portbench_traffic_{gen}")


def reader(metric: str, root: Path = ROOT):
    """metrics/<metric>.py's `read(readings) -> float | None`."""
    label = "portbench_metric_" + metric.replace(".", "_").replace("-", "_")
    return _module(root / "portbench" / "metrics" / f"{metric}.py", label).read
