"""The port's package surface against the JAX package's: the top level and
each subpackage export the same names (`__all__`), and every exported name
resolves. A subpackage whose reference exports no `__all__` exports none in
the port either. `native/` has no counterpart by design (the port's
ops/bn254_ref.py stands in for it). The port exports one name more:
`service.SloTier`, the port's own.
"""

import importlib
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = sorted(
    p.parent.name for p in (ROOT / "handel_tpu").glob("*/__init__.py")
    if p.parent.name != "native"
)
# names the port exports that the reference does not, by subpackage
PORT_OWN = {"service": {"SloTier"}}


def exported(pkg: str):
    mod = importlib.import_module(pkg)
    names = getattr(mod, "__all__", None)
    if names is not None:
        for name in names:
            assert hasattr(mod, name), f"{pkg}.__all__ names {name}, which is not there"
        assert len(set(names)) == len(names), f"{pkg}.__all__ repeats a name"
        names = set(names)
    return names


def test_top_level_exports_the_reference_surface():
    assert exported("handel_tpu_torch") == exported("handel_tpu")
    assert len(exported("handel_tpu_torch")) == 13


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_reference_surface(sub):
    assert (ROOT / "handel_tpu_torch" / sub / "__init__.py").exists()
    ours = exported(f"handel_tpu_torch.{sub}")
    theirs = exported(f"handel_tpu.{sub}")
    if theirs is None:
        assert ours is None
        return
    assert ours - PORT_OWN.get(sub, set()) == theirs


def test_native_has_no_counterpart_and_the_port_owns_its_extras():
    assert not (ROOT / "handel_tpu_torch" / "native").exists()
    for sub, names in PORT_OWN.items():
        ours = exported(f"handel_tpu_torch.{sub}")
        assert names <= ours and not names & exported(f"handel_tpu.{sub}")


def test_ci_torch_workflow_runs_every_port_script_on_the_cpu():
    """.github/workflows/ci_torch.yml parses, runs the port's tests with the
    card's tests left out, and has a named step for each smoke of
    handel_tpu_torch/scripts/, the stage profile, capture and eddsa_compare,
    each on the CPU."""
    import yaml

    wf = yaml.safe_load((ROOT / ".github" / "workflows" / "ci_torch.yml").read_text())
    steps = [s for s in wf["jobs"]["cpu"]["steps"] if "name" in s]
    runs = {s["name"]: s["run"] for s in steps}
    assert 'tests/test_torch_*.py -m "not slow and not cuda"' in runs["port tests (CPU)"]
    scripts = sorted(p.stem for p in (ROOT / "handel_tpu_torch" / "scripts").glob("*_smoke.py"))
    assert len(scripts) == 13
    for name in [*scripts, "verify_profile", "capture", "eddsa_compare"]:
        hits = [n for n, r in runs.items()
                if re.search(rf"-m handel_tpu_torch\.scripts\.{name}(\s|$)", r)]
        assert len(hits) == 1, name
    for n, r in runs.items():
        if any(k in r for k in ("launch_smoke", "multichip_smoke", "rns_smoke", "rlc_smoke",
                                "verify_profile")):
            assert "--device cpu" in r, n
