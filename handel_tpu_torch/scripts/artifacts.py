"""What the port's scripts write beside their figures: the card's line from
nvidia-smi and an atomic JSON write (counterpart of bench.py
`write_json_atomic`)."""

from __future__ import annotations

import json
import os
import subprocess
import tempfile

import torch


def card_line(device: torch.device) -> str | None:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them for
    `device` (its first line where the index is unknown); None on the CPU.
    A card whose clocks sit under a lower power limit runs slower, so every
    time a script keeps stands beside this line."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    index = device.index if device.index is not None else 0
    return lines[index] if index < len(lines) else lines[0]


def write_json_atomic(path: str, obj) -> None:
    """`obj` as indented JSON at `path`, through a temporary file in the same
    directory and one rename: a reader never sees half a file, and a write
    killed part way leaves the old file whole."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tmp_", suffix=".json", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
