#!/usr/bin/env python3
"""Device time per call of kernels B1 and B2 of the PyTorch + CUDA port
(handel_tpu_torch) at the widths chip_smoke.py times them, for comparing two
trees on one card.

    python3 kernel_times.py [--tree DIR] [--label NAME]

Imports handel_tpu_torch from DIR (default: the directory of this script),
so a copy of another commit, unpacked with `git archive` into a directory
that .gitignore lists, is timed by the same code. To compare two commits,
run both in one command on one card, in turns: old, new, new, old. Each
figure is chip_smoke.py's `graph_ms`: the slope of CUDA-graph chains whose
calls read their operands from device memory. Every result is first held
against the tree's plain version, exactly. Where the tree's wrapper builds
several instances (B1's lanes per column `tpi`, B2's columns per block
`tile`), each is timed too (`by_instance`). Prints one JSON line per kernel
and width, then the card's name and power limit, then one JSON line with all
figures. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_smoke():
    """chip_smoke.py beside this script, as a module (its helpers import
    handel_tpu_torch only when called)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE), help="checkout whose handel_tpu_torch to time")
    ap.add_argument("--label", default="", help="name printed with every figure")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smoke = load_smoke()
    import handel_tpu_torch
    from handel_tpu_torch.kernels import build
    from handel_tpu_torch.ops import bn254_ref as bn
    from handel_tpu_torch.ops.fp import Field

    if Path(handel_tpu_torch.__file__).resolve().parents[1] != Path(args.tree).resolve():
        raise AssertionError(f"handel_tpu_torch imported from {handel_tpu_torch.__file__}")
    build.build_all(("fp_mont", "rns_mont"))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(smoke.SEED)
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident

    f12 = 54 * 2 * smoke.LANES
    wide = (1 << 20) + 16
    # the verify path's calls run from 128 to 9 N C columns (B1) and to the
    # Fp12 width (B2): the narrowest, two common ones, the Fp12 width, widths
    # between it and 2^20, and the widest dense add
    common = (smoke.LANES, 12 * smoke.LANES, 36 * smoke.LANES)
    b1_widths = (*common, f12, 3 * f12 // 2, 2 * f12, 4 * f12, 16 * f12, wide,
                 9 * smoke.N_REGISTRY * smoke.LANES)
    b2_widths = (*common, f12, 2 * f12, 4 * f12, 8 * f12, 16 * f12, wide)
    instances = {"fp_mont_mul": (mont_mul, "tpi", (1, 2, 4)),
                 "rns_mont_mul_resident": (rns_mul_resident, "tile", (32, 64))}
    cases = [
        ("fp_mont_mul", Field(bn.P, device=dev), b1_widths),
        ("fp_mont_mul", Field(smoke.BLS12_381_P, device=dev), (f12, wide)),
        ("rns_mont_mul_resident", Field(bn.P, backend="rns", device=dev), b2_widths),
        ("rns_mont_mul_resident", Field(smoke.BLS12_381_P, backend="rns", device=dev),
         (f12, 4 * f12, wide)),
    ]
    figs = []
    for name, F, widths in cases:
        for cols in widths:
            if name == "fp_mont_mul":
                a, b = smoke.operand_pair(F, cols, rng, with_edges=True)
                fn, plain, rows = F.mul, F._mul_plain, F.nlimbs
                bound = smoke.mont_mul_bound_ms(F.nlimbs, cols)
            else:
                a = smoke.random_residues(F, cols, rng)
                b = smoke.random_residues(F, cols, rng)
                fn, plain, rows = F.mul_resident, F._mul_resident_core, F.k_all
                bound = smoke.rns_bound_ms(F, cols)
            a, b = a.to(dev), b.to(dev)
            if not torch.equal(fn(a, b), plain(a, b)):
                raise AssertionError(f"{name} != plain at {rows} rows, {cols} columns")
            fig = dict(label=args.label, kernel=name, rows=rows, cols=cols,
                       ms=smoke.graph_ms(fn, a, b), bound_ms=bound[0], bound_by=bound[1])
            kernel, attr, choices = instances[name]
            if hasattr(kernel, attr):
                fig["by_instance"] = smoke.each_instance(
                    kernel, attr, choices, lambda: smoke.graph_ms(fn, a, b))
            smoke.line("kernel_time", **fig)
            figs.append(fig)
            del a, b
            torch.cuda.empty_cache()
    print(smoke.nvidia_smi())
    print(json.dumps({"label": args.label, "kernel_times": figs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
