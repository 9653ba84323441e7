#!/usr/bin/env python3
"""Device time per call of kernels B1, B2, B3a and B3b of the PyTorch + CUDA
port (handel_tpu_torch) at the widths chip_smoke.py times them, for
comparing two trees on one card.

    python3 kernel_times.py [--tree DIR] [--label NAME] [--kernels b1,b2,b3]

Imports handel_tpu_torch from DIR (default: the directory of this script),
so a copy of another commit, unpacked with `git archive` into a directory
that .gitignore lists, is timed by the same code. To compare two commits,
run both in one command on one card, in turns: old, new, new, old, e.g.

    git archive HEAD~1 | tar -x -C checkout/parent
    for t in checkout/parent . . checkout/parent; do
        python3 kernel_times.py --tree $t --label $t --kernels b3; done

Each figure is chip_smoke.py's `graph_ms`: the slope of CUDA-graph chains
whose calls read their operands from device memory. Every result is first
held against the tree's plain version, exactly. Where the tree's wrapper
builds several instances (B1's lanes per column `tpi`, B2's columns per
block `tile`, B3a's and B3b's block sizes: threads before their redesign,
warps after), each is timed too (`by_instance`). B3a and B3b (the kernel
lab's formulations, `--kernels b3`) run at the lab's batch 2^18 and at
2^20 + 16 columns of 16 limbs, and at 2^20 + 16 of 24, on canonical
operands led by edge pairs; the tree's built lab kernels' SASS
instructions per column (cuobjdump) are printed too. Prints one JSON line
per kernel and width, then the card's name and power limit, then one JSON
line with all figures. Beside each kernel time, `plain_ms` is the device
time of the plain PyTorch version on the same operands (CUDA events, mean
of 3 warm calls). Exits non-zero without a CUDA device.
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
    ap.add_argument("--kernels", default="b1,b2,b3",
                    help="comma-separated subset of b1, b2, b3 (B3a and B3b)")
    args = ap.parse_args(argv)
    which = set(args.kernels.split(","))
    if not which <= {"b1", "b2", "b3"}:
        ap.error(f"--kernels: unknown {sorted(which - {'b1', 'b2', 'b3'})}")
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
    build.build_all(tuple(src for k, src in (("b1", "fp_mont"), ("b2", "rns_mont"),
                                             ("b3", "lab_mont")) if k in which))
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
    cases = []
    if "b1" in which:
        cases += [("fp_mont_mul", Field(bn.P, device=dev), b1_widths),
                  ("fp_mont_mul", Field(smoke.BLS12_381_P, device=dev), (f12, wide))]
    if "b2" in which:
        cases += [("rns_mont_mul_resident", Field(bn.P, backend="rns", device=dev), b2_widths),
                  ("rns_mont_mul_resident", Field(smoke.BLS12_381_P, backend="rns", device=dev),
                   (f12, 4 * f12, wide))]
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
                       ms=smoke.graph_ms(fn, a, b), bound_ms=bound[0], bound_by=bound[1],
                       plain_ms=smoke.cuda_ms(lambda: plain(a, b), 3))
            kernel, attr, choices = instances[name]
            if hasattr(kernel, attr):
                fig["by_instance"] = smoke.each_instance(
                    kernel, attr, choices, lambda: smoke.graph_ms(fn, a, b))
            smoke.line("kernel_time", **fig)
            figs.append(fig)
            del a, b
            torch.cuda.empty_cache()
    if "b3" in which:
        figs += lab_times(smoke, build, dev, rng, args.label)
    print(smoke.nvidia_smi())
    print(json.dumps({"label": args.label, "kernel_times": figs}))
    return 0


def lab_times(smoke, build, dev, rng, label: str) -> list[dict]:
    """B3a and B3b of the imported tree: each held against its plain body
    on canonical operands, then timed, default instance and every instance
    the tree builds; then the SASS instructions per column of the tree's
    built lab kernels."""
    import torch

    from handel_tpu_torch.kernels import lab_mont
    from handel_tpu_torch.ops import bn254_ref as bn
    from handel_tpu_torch.ops.fp import Field
    from handel_tpu_torch.scripts.fp_kernel_lab import LabField

    choices = getattr(lab_mont, "WARPS", None) or lab_mont.THREADS
    wide = (1 << 20) + 16
    figs = []
    for p, widths in ((bn.P, (1 << 18, wide)), (smoke.BLS12_381_P, (wide,))):
        lab = LabField(Field(p, device=dev))
        for cols in widths:
            a, b = smoke.operand_pair(lab.F, cols, rng, with_edges=True)
            a, b = a.to(dev), b.to(dev)
            for form in ("separated", "cios_fullwidth"):
                body = lab.body(form)
                want = body(a, b)
                for c in choices:
                    if not torch.equal(lab.kernel(form, c)(a, b), want):
                        raise AssertionError(f"lab {form} {c} != plain at {lab.n} limbs, {cols}")
                fn = lab.kernel(form)
                fig = dict(label=label, kernel=f"lab_{form}", rows=lab.n, cols=cols,
                           ms=smoke.graph_ms(fn, a, b),
                           bound_ms=smoke.mont_mul_bound_ms(lab.n, cols)[0],
                           plain_ms=smoke.cuda_ms(lambda: body(a, b), 3),
                           by_instance={str(c): smoke.graph_ms(lab.kernel(form, c), a, b)
                                        for c in choices})
                smoke.line("kernel_time", **fig)
                figs.append(fig)
            del a, b, want
            torch.cuda.empty_cache()
    sass = smoke.sass_profile(build.library_path("lab_mont"))
    smoke.line("kernel_time", label=label, lab_sass=sass if sass is not None
               else "not read: the CUDA toolkit has no cuobjdump")
    return figs


if __name__ == "__main__":
    sys.exit(main())
