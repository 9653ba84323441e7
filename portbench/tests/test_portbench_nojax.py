"""No module that a run imports has the top-level name of JAX or of the
JAX package; the check compares whole top-level names."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.harness import checks, spec


def test_the_check_compares_whole_top_level_names():
    assert checks.forbidden_modules(["handel_tpu_torch", "handel_tpu_torch.ops.fp"]) == []
    assert checks.forbidden_modules(["jaxtyping", "flaxen", "handel_tpux"]) == []
    assert checks.forbidden_modules(["handel_tpu.ops.fp", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "handel_tpu", "jax", "jaxlib"
    ]


def test_nothing_a_run_imports_is_jax():
    """Import, in a fresh process, every module a run of every cell loads:
    the harness, each configuration's engine, the service, each mix's
    generator and each metric's reader."""
    code = f"""
import json, sys
sys.path.insert(0, {str(spec.ROOT)!r})
import importlib
import portbench.run
from portbench.harness import cell_run, checks, drive, profile, spec
bench = spec.load_benchmark()
for w in bench["workloads"]:
    cell = spec.load_cell(w["name"])
    mod, _cls = cell.config["constructor"].split(":")
    importlib.import_module(mod)
    spec.generator(cell.mix)
    for m in cell.end_to_end + cell.per_layer:
        spec.reader(m["name"])
importlib.import_module("handel_tpu_torch.parallel.batch_verifier")
importlib.import_module("handel_tpu_torch.core.bitset")
drive.kernel_counters()
print(json.dumps(checks.forbidden_modules(sys.modules)))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=spec.ROOT)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.splitlines()[-1]) == []
