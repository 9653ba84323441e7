"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each kernel source `csrc/<name>.cu` has a plain C entry point and builds,
on first use, into one shared library under `build/torch_kernels/` at the
root of the checkout (listed in .gitignore):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/lib<name>-<hash>.so \
         csrc/<name>.cu

The file name carries a hash of the sources and flags, so an edited source
rebuilds and a stale library is never loaded. Only the repository's own
sources and the CUDA toolkit's headers are compiled; no PyTorch header is
included, which keeps a build at seconds. `build_all` starts one nvcc per
source, all at once. nvcc's output (ptxas's register and spill report) is
kept beside each library as `<library>.log`.

`BUILT` (name -> nvcc seconds) and `LOADED` (names) record what this process
built and loaded, for the card's telemetry (parallel/telemetry.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# every kernel source of the port (csrc/<name>.cu)
KERNELS = ("fp_mont", "rns_mont", "lab_mont")

# this process's nvcc builds (name -> seconds) and library loads
BUILT: dict[str, float] = {}
LOADED: set[str] = set()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, the PATH, or /usr/local/cuda; raises if none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu builds to, keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    log_path(out).write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def log_path(library: Path) -> Path:
    """Where nvcc's output for `library` is kept."""
    return library.with_name(library.name + ".log")


def build_all(names=KERNELS) -> dict[str, tuple[float, str]]:
    """Build every named source that is not built yet, one nvcc process per
    source, all started together. Returns {name: (seconds, nvcc output)};
    an already-built library reports 0.0 seconds and the output kept from
    its build."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    out = {}
    for n, s in started.items():
        if s is None:
            kept = log_path(library_path(n))
            out[n] = (0.0, kept.read_text() if kept.exists() else "")
        else:
            log = _finish(n, s)
            out[n] = (time.perf_counter() - t0, log)
            BUILT[n] = out[n][0]
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and load it."""
    t0 = time.perf_counter()
    started = _start(name)
    if started is not None:
        _finish(name, started)
        BUILT[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(library_path(name)))
    LOADED.add(name)
    return lib
