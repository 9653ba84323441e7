"""The port stands alone: no JAX, nothing of handel_tpu, no silent CPU.

* Every module of handel_tpu_torch, chip_smoke.py and kernel_times.py
  imports in a fresh interpreter where `jax`, `cryptography` and
  `matplotlib` cannot be imported (the card's machine has neither of the
  last two) and a finder refuses every `handel_tpu` module (but not
  `handel_tpu_torch`).
  tests/conftest.py imports jax into every test process, so this runs in a
  subprocess.
* A static scan of the same files finds no import of either.
* Asking for `cuda` without a card raises; CPU tensors launch no kernel.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "handel_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_times.py"]

BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

sys.modules["jax"] = None  # `import jax` now raises ImportError
# the card's machine has neither: no module may need them at import
sys.modules["cryptography"] = None
sys.modules["matplotlib"] = None


class RefuseReference(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "handel_tpu" or name.startswith("handel_tpu."):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, RefuseReference())
import handel_tpu_torch

names = ["handel_tpu_torch"]
for info in pkgutil.walk_packages(handel_tpu_torch.__path__, "handel_tpu_torch."):
    names.append(info.name)
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
import kernel_times  # noqa: F401
leaked = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and (m in ("jax", "cryptography", "matplotlib")
                            or m.startswith(("jax.", "handel_tpu.")))
)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_with_jax_and_reference_blocked():
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    modules = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    }
    assert int(out.stdout.split()[-1]) == len(modules)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "handel_tpu"), (path, name)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from handel_tpu_torch.models.bn254_torch import BN254TorchScheme
    from handel_tpu_torch.ops import bn254_ref as bn
    from handel_tpu_torch.ops.fp import Field
    from handel_tpu_torch.utils.torchenv import resolve_device

    for make in (
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: Field(bn.P),
        lambda: BN254TorchScheme(),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_count_no_kernel_launch():
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.ops.pairing import BN254Pairing

    pr = BN254Pairing(device="cpu")
    before = mont_mul.launches
    F, T = pr.F, pr.T
    a = T.f12_pack([(((1, 2), (3, 4), (5, 6)), ((7, 8), (9, 10), (11, 12)))])
    T.f12_mul(a, a)
    F.inv(F.pack([3]))
    assert mont_mul.launches == before
