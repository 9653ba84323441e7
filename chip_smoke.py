#!/usr/bin/env python3
"""Bring-up check of the PyTorch + CUDA port (handel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero with no result line:

  1. device   the card's name, and its name and power limit from nvidia-smi
  2. build    nvcc builds every kernel source of the port (csrc/*.cu), one
              process per source, all at once; per kernel instance its
              registers, spills and static shared memory (ptxas), B2's
              dynamic shared memory and its IMMA (int8 tensor-core)
              instructions in the built SASS (cuobjdump); a B2 instance
              without IMMA, or a B1 or B2 instance that spills, fails
  3. ragged   B1 (each lanes-per-column instance) and B2 (each tile width)
              against their plain versions, exactly, at 1, 7, 31, 33, 63,
              65, 127, 129, 4099 and 13,824 columns, contiguous and as a
              row slice at a column offset of 3 (rows not 16-byte aligned)
     kernel   kernel B1, the Montgomery multiply (Field.mul on CUDA tensors),
              against its plain PyTorch version on the card, exact equality,
              for BN254 (16 limbs) and BLS12-381 (24 limbs): 2^20 seeded
              random columns plus edge columns, and the widths the verify
              path gives it (an Fp12 multiply at 128 lanes; the widest
              stacked G2 add of the dense class); kernel and plain times,
              and the device time of each lanes-per-column instance
     rns_kernel  kernel B2, the resident RNS Montgomery multiply
              (RnsField.mul_resident on CUDA tensors), against its plain
              version, exact equality, for BN254 (k_all 46) and BLS12-381
              (k_all 65): 2^20 + 16 random residue columns with 0 and m_i - 1
              first, and an Fp12 multiply at 128 lanes; the integer identity
              x y M^-1 mod p through the resident conversions on a prefix;
              the device time of each tile width
     lab_kernel  kernels B3a and B3b, the kernel lab's two formulations of
              B1's product (csrc/lab_mont.cu), each against its plain version
              and against B1, exact equality, at 16 limbs (2^20 + 16 columns
              with edge pairs, the lab's batch 2^18, an Fp12 multiply at 128
              lanes) and 24 limbs (2^20 + 16); and against its plain version
              on the lab's own race inputs, 2^18 columns of raw 16-bit digits
              Every kernel figure of phase 3 is a device time per call: chains
              of calls captured in one CUDA graph and replayed, by
              chained_marginal's slope (handel_tpu_torch/ops/fp.py), each
              call reading operands that no recent call left in the L2 cache
              (ColdOperands), so the bytes bound holds at every width; the
              back-to-back eager figure, which measures the host's issue
              rate at narrow widths, stays beside it as `eager_ms`. One graph
              per kernel, of dependent calls, is replayed over a sentinel
              and held against an eager chain of the same depth, exactly.
  4. verify   BN254TorchScheme on a 4096-key registry with 128 lanes: a range
              launch of 64 candidates and a dense launch of 126, each with
              forged lanes (wrong signature, wrong message), an empty bitset
              and padded lanes; verdicts must equal the ones known by
              construction, and B1's launch counter must grow during the
              run; a small pairing is held against the scalar oracle; p50
              wall ms per launch class, kernel launches per verify, peak
              device memory
     rns_verify  the same launches through BN254TorchScheme(fp_backend="rns")
              (the resident pairing): the same verdicts, B2 launched and B1
              not, conversion counts, p50 per class, peak memory; a 2-lane
              resident pairing against the scalar oracle. Each path prints
              its kernel's calls by column count (`widths`)
  5. profile  one range launch of each path under torch.profiler: device
              activities, busy time against wall time, the costliest kernels;
              the path's kernel's device ms against the sum of its bound
              over the launch's calls
  6. lab      the kernel lab (python -m handel_tpu_torch.scripts.fp_kernel_lab)
              at batch 2^18 and 2^20, the outer-product lab
              (...scripts.mxu_limb_lab) at 2^15 with the card's int8 ceiling,
              and the production field's marginal rate for cios and rns
              (python -m handel_tpu_torch.ops.fp): muls/s per candidate, each
              candidate validated first; any failure fails the run. B3a and
              B3b must run here, B2 must not; the kernels a lab run executed
              are its wrapper counts less the calls captured into graphs plus
              the calls the graphs replayed.

Each path of phases 4 and 6 is one main-path run: every kernel's launch
count is set to 0 just before it and read just after. Then one JSON line of
kernel figures, the nvidia-smi line again, and last {"ok": true, "device":
{...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import random
import re
import statistics
import subprocess
import sys
import time

import numpy as np

MSG = b"handel chip smoke"
SEED = 2024
N_REGISTRY = 4096
LANES = 128
RANGE_CANDIDATES = 64
DENSE_CANDIDATES = 126
TIMED_LAUNCHES = 3
BLS12_381_P = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaaab",
    16,
)
# H100 SXM data-sheet rates: HBM3 3.35 TB/s; int32 64 lanes per SM per clock
# (half the 128 FP32 lanes behind the 67 TFLOP/s FP32 figure) x 132 SMs x
# 1.98 GHz = 16.7 T int32 operations/s
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
L2_BYTES = 50 << 20  # H100 L2 cache, 50 MB


def line(phase: str, **kw) -> None:
    print(f"{phase}: " + json.dumps(kw, sort_keys=True), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over `iters` calls, by CUDA events (warm)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class ColdOperands:
    """fn over a ring of copies of (a, b) that holds more than twice the L2
    cache, for chained_marginal: each call ignores the chain's operands and
    takes the ring's next pair, so what it reads was last touched a ring's
    worth of bytes ago. The first call of a chain (chain() hands it the
    chain's start, `a`) first reads a buffer of twice the L2 size, which
    evicts what an earlier replay of the same graph left there; that fixed
    cost per chain cancels in chained_marginal's slope. So every call reads
    its operands from device memory, and the bytes bound (inputs over HBM
    bandwidth) is a bound at every width."""

    def __init__(self, fn, a, b):
        import torch

        per_call = (a.numel() + b.numel()) * a.element_size()
        copies = -(-2 * L2_BYTES // per_call)
        self.ring = [(a, b)] + [(a.clone(), b.clone()) for _ in range(copies - 1)]
        self.evict = torch.ones(2 * L2_BYTES // 4, dtype=torch.int32, device=a.device)
        self.a, self.fn, self.calls = a, fn, 0

    def __call__(self, out, _b):
        if out is self.a:
            self.evict.max()
        x, y = self.ring[self.calls % len(self.ring)]
        self.calls += 1
        return self.fn(x, y)


def graph_ms(fn, a, b) -> float:
    """Device time of one call of fn on (a, b), in ms, operands read from
    device memory: the slope of 8- and 72-deep chains of calls, each captured
    in one CUDA graph and replayed (chained_marginal), the calls taking their
    operands from a ColdOperands ring. Raises when the slope is not
    measurable."""
    from handel_tpu_torch.ops.fp import chained_marginal

    rate, _floor = chained_marginal(ColdOperands(fn, a, b), a, b, k1=8, k2=72, trials=5)
    if rate is None:
        raise AssertionError("graph chain slope not measurable")
    return a.shape[1] / rate * 1e3


def replay_check(fn, a, b, counter, depth: int = 8) -> None:
    """A captured chain of `depth` calls, replayed over a sentinel, must equal
    the eager chain exactly; the wrapper counts its launches at capture
    (3 warm calls and `depth` captured) and not at replay."""
    import torch

    from handel_tpu_torch.ops.fp import ChainGraph, chain

    before = counter.launches
    g = ChainGraph(fn, a, b, depth)
    if counter.launches - before != 3 + depth:
        raise AssertionError(f"capture counted {counter.launches - before} launches")
    g.out.fill_(-1)
    before = counter.launches
    got = g.replay().clone()
    if counter.launches != before:
        raise AssertionError("a graph replay moved the launch counter")
    if not torch.equal(got, chain(fn, a, b, depth)):
        raise AssertionError("graph replay != eager chain")
    del g
    torch.cuda.empty_cache()


def ptxas_summary(log: str) -> dict[str, list[int]]:
    """{kernel<template args>: [registers, spill store bytes, spill load
    bytes, static shared memory bytes]} from nvcc -Xptxas -v output."""
    out, cur, spill = {}, None, [0, 0]
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = kernel_label(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = [int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            smem = re.search(r"(\d+) bytes smem", ln)
            out[cur] = [int(m.group(1)), *spill, int(smem.group(1)) if smem else 0]
            cur, spill = None, [0, 0]
    return out


def kernel_label(mangled: str) -> str:
    """kernel<template args> for a mangled kernel name, else the name."""
    k = re.search(r"([a-z][a-z_]*_kernel)I((?:Li\d+E)+)E", mangled)
    if not k:
        return mangled
    return f"{k.group(1)}<{','.join(re.findall(r'Li(\d+)E', k.group(2)))}>"


def sass_counts(lib, opcode: str) -> dict[str, int]:
    """{kernel<template args>: instructions of `opcode`} in a built
    library's SASS (cuobjdump -sass, from nvcc's toolkit)."""
    from pathlib import Path

    from handel_tpu_torch.kernels.build import nvcc_path

    tool = Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = kernel_label(m.group(1))
            out.setdefault(cur, 0)
        elif cur is not None and re.search(rf"\b{opcode}\b", ln):
            out[cur] += 1
    return out


def mont_mul_bound_ms(nlimbs: int, cols: int) -> tuple[float, str]:
    """Least time for `cols` Montgomery products: the bytes (a and b read
    once, out written once, int32 limbs) over HBM bandwidth against the
    32x32->64-bit multiply-adds of word-serial CIOS (2 N^2 + N per column
    for N = nlimbs/2 words, two int32 multiply-adds each) over the int32
    rate. Returns (ms, "bytes" or "operations")."""
    words = nlimbs // 2
    t_bytes = 3 * nlimbs * 4 * cols / HBM_BYTES_PER_S
    t_ops = 2 * (2 * words * words + words) * cols / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rns_bound_ms(F, cols: int) -> tuple[float, str]:
    """Least time for `cols` resident RNS products (kernel B2): the bytes
    (a and b read once, out written once, K = k_all int32 residues each)
    over HBM bandwidth against the integer operations counted from the
    kernel's code over the int32 rate: each product or multiply-add one,
    each modular reduction two (a quotient multiply and a multiply-
    subtract). Returns (ms, "bytes" or "operations")."""
    kA, kB, K = F.kA, F.kB, F.k_all
    mads = K + kA + (kB + 1) * kA + 2 * (kB + 1) + 2 * kB + 1 + kA * kB + kA
    mods = K + kA + 3 * (kB + 1) + 2 * kB + 2 + 3 * kA
    t_bytes = 3 * K * 4 * cols / HBM_BYTES_PER_S
    t_ops = (mads + 2 * mods) * cols / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def random_residues(F, cols: int, rng: np.random.Generator):
    """(k_all, cols) residues, each row below its modulus, with 0 and
    m_i - 1 in the first two columns."""
    import torch

    m = F._m_all.astype(np.int64)[:, None]
    r = rng.integers(0, 1 << 40, size=(F.k_all, cols)) % m
    r[:, 0], r[:, 1] = 0, m[:, 0] - 1
    return torch.from_numpy(r.astype(np.int32))


def rns_kernel_phase(F, widths: dict[str, int], rng) -> dict:
    """Kernel B2 against its plain version on the card at each width, and
    the integer identity on a prefix; returns per-width figures. Raises on
    any difference."""
    import torch

    from handel_tpu_torch.kernels.rns_mont import TILES, rns_mul_resident, tile_for

    dev = F.device
    out = {}
    for label, cols in widths.items():
        a = random_residues(F, cols, rng).to(dev)
        b = random_residues(F, cols, rng).to(dev)
        before = rns_mul_resident.launches
        got = F.mul_resident(a, b)
        if rns_mul_resident.launches != before + 1:
            raise AssertionError("mul_resident on CUDA tensors did not launch kernel B2")
        want = F._mul_resident_core(a, b)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"B2 != plain at k_all={F.k_all} width {label}: max err {err}")
        # the integer identity through the resident conversions
        k = min(cols, 256)
        xs = F.unpack(random_columns(F, k, rng), mont=False)
        ys = F.unpack(random_columns(F, k, rng), mont=False)
        r = F.mul_resident(F.to_resident(F.pack(xs, mont=False)),
                           F.to_resident(F.pack(ys, mont=False)))
        minv = pow(F.M, -1, F.p)
        if F.unpack(F.from_resident(r), mont=False) != [x * y * minv % F.p for x, y in zip(xs, ys)]:
            raise AssertionError(f"B2 != integer identity at k_all={F.k_all} width {label}")
        if label == next(iter(widths)):
            replay_check(F.mul_resident, a, b, rns_mul_resident)
        ms = graph_ms(F.mul_resident, a, b)
        eager_ms = cuda_ms(lambda: F.mul_resident(a, b), 20)
        plain_ms = cuda_ms(lambda: F._mul_resident_core(a, b), 3)
        bound, bound_by = rns_bound_ms(F, cols)
        out[label] = dict(
            k_all=F.k_all, cols=cols, max_abs_err=err, ms=ms, eager_ms=eager_ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
            tile=tile_for(cols),
            ms_by_tile=each_instance(rns_mul_resident, "tile", TILES,
                                     lambda: graph_ms(F.mul_resident, a, b)),
        )
        line("rns_kernel", **out[label], width=label)
        del a, b, got, want
        torch.cuda.empty_cache()
    return out


def random_columns(F, cols: int, rng: np.random.Generator):
    """(nlimbs, cols) canonical values < p: uniform limbs below a top limb
    drawn under p's top limb."""
    import torch

    a = rng.integers(0, 1 << 16, size=(F.nlimbs, cols), dtype=np.int64)
    a[-1] = rng.integers(0, int(F.p_limbs_np[-1]), size=cols)
    return torch.from_numpy(a.astype(np.int32))


def operand_pair(F, cols: int, rng: np.random.Generator, with_edges: bool):
    """Two (nlimbs, cols) CPU tensors of canonical values; with_edges puts
    every pair of 0, 1, p-1, R mod p in the first 16 columns."""
    import torch

    a = random_columns(F, cols, rng)
    b = random_columns(F, cols, rng)
    if with_edges:
        edges = [0, 1, F.p - 1, F.mont_r]
        ea = F.pack_batch_np([x for x in edges for _ in edges], mont=False)
        eb = F.pack_batch_np([y for _ in edges for y in edges], mont=False)
        a[:, : ea.shape[1]] = torch.from_numpy(ea)
        b[:, : eb.shape[1]] = torch.from_numpy(eb)
    return a, b


def each_instance(kernel, attr: str, choices, measure) -> dict:
    """{choice: measure()} with the wrapper's `attr` (B1's lanes per
    column, B2's tile width) forced to each choice in turn, then restored."""
    keep = getattr(kernel, attr)
    out = {}
    try:
        for choice in choices:
            setattr(kernel, attr, choice)
            out[str(choice)] = measure()
    finally:
        setattr(kernel, attr, keep)
    return out


# widths around B1's warps and B2's tiles, and the Fp12 width at 128 lanes
RAGGED = (1, 7, 31, 33, 63, 65, 127, 129, 4099, 54 * 2 * 128)


def ragged_phase(cios_fields, rns_fields, rng) -> dict:
    """B1 (every lanes-per-column instance and the wrapper's own choice) and
    B2 (every tile width) against their plain versions, exactly, at each
    RAGGED width: on contiguous operands, and on a row slice of a wider
    array at a column offset of 3, whose rows are not 16-byte aligned (B2's
    4-byte copies). Returns {kernel/rows: widths checked}. Raises on any
    difference."""
    import torch

    from handel_tpu_torch.kernels.fp_mont import TPI_CHOICES, mont_mul
    from handel_tpu_torch.kernels.rns_mont import TILES, rns_mul_resident

    def check(name, F, fn, plain, full_a, full_b, kernel, attr, choices):
        cols = full_a.shape[1] - 3
        a, b = full_a[:, :cols].contiguous(), full_b[:, :cols].contiguous()
        sliced = full_a[:, 3:]
        want, want_sliced = plain(a, b), plain(sliced, b)
        got = each_instance(kernel, attr, (getattr(kernel, attr), *choices),
                            lambda: (fn(a, b), fn(sliced, b)))
        for choice, (g, gs) in got.items():
            if not (torch.equal(g, want) and torch.equal(gs, want_sliced)):
                raise AssertionError(f"{name} != plain at {cols} columns ({attr} {choice})")

    out = {}
    for F in cios_fields:
        for cols in RAGGED:
            a, b = operand_pair(F, cols + 3, rng, with_edges=cols >= 16)
            check("B1", F, F.mul, F._mul_plain, a.to(F.device), b.to(F.device),
                  mont_mul, "tpi", TPI_CHOICES)
        out[f"fp_mont_mul/{F.nlimbs}"] = list(RAGGED)
    for F in rns_fields:
        for cols in RAGGED:
            a = random_residues(F, cols + 3, rng).to(F.device)
            b = random_residues(F, cols + 3, rng).to(F.device)
            check("B2", F, F.mul_resident, F._mul_resident_core, a, b,
                  rns_mul_resident, "tile", TILES)
        out[f"rns_mont_mul_resident/{F.k_all}"] = list(RAGGED)
    torch.cuda.synchronize()
    line("ragged", checked=out, unaligned_offset=3, max_abs_err=0)
    return out


def kernel_phase(F, widths: dict[str, int], rng, with_edges: bool) -> dict:
    """Kernel against the plain version on the card at each width; returns
    per-width figures. Raises on any difference."""
    import torch

    from handel_tpu_torch.kernels.fp_mont import TPI_CHOICES, lanes_for, mont_mul

    dev = F.device
    out = {}
    for label, cols in widths.items():
        a, b = operand_pair(F, cols, rng, with_edges)
        a, b = a.to(dev), b.to(dev)
        before = mont_mul.launches
        got = F.mul(a, b)
        if mont_mul.launches != before + 1:
            raise AssertionError("Field.mul on CUDA tensors did not launch the kernel")
        want = F._mul_plain(a, b)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at n={F.nlimbs} width {label}: max err {err}")
        # the plain version itself against Python integers on a prefix
        k = min(cols, 256)
        rinv = pow(F.mont_r, -1, F.p)
        xs, ys = F.unpack(a[:, :k], mont=False), F.unpack(b[:, :k], mont=False)
        if F.unpack(got[:, :k], mont=False) != [x * y * rinv % F.p for x, y in zip(xs, ys)]:
            raise AssertionError(f"kernel != integer oracle at n={F.nlimbs} width {label}")
        launches = mont_mul.launches - before
        if label == next(iter(widths)):
            replay_check(F.mul, a, b, mont_mul)
        ms = graph_ms(F.mul, a, b)
        eager_ms = cuda_ms(lambda: F.mul(a, b), 20 if cols <= 1 << 20 else 5)
        plain_ms = cuda_ms(lambda: F._mul_plain(a, b), 3)
        bound, bound_by = mont_mul_bound_ms(F.nlimbs, cols)
        out[label] = dict(
            nlimbs=F.nlimbs, cols=cols, max_abs_err=err, ms=ms, eager_ms=eager_ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, launches=launches,
            tpi=lanes_for(cols),
            ms_by_tpi=each_instance(mont_mul, "tpi", TPI_CHOICES, lambda: graph_ms(F.mul, a, b)),
        )
        line("kernel", **out[label], width=label)
        del a, b, got, want
        torch.cuda.empty_cache()
    return out


def lab_kernel_phase(F, widths: dict[str, int], rng) -> dict:
    """Kernels B3a and B3b against their plain bodies and against B1 on the
    card at each width (canonical operands led by the edge pairs), and
    against their plain bodies on the lab's own race inputs (2^18 columns of
    raw 16-bit digits, values up to R - 1), exact; returns {kernel:
    {width/nlimbs: figures}}. Raises on any difference."""
    import torch

    from handel_tpu_torch.kernels.lab_mont import lab_cios_fullwidth, lab_separated
    from handel_tpu_torch.scripts.fp_kernel_lab import LabField, raw_operands

    lab = LabField(F)
    dev = F.device
    forms = (("lab_cios_fullwidth", lab_cios_fullwidth, "cios_fullwidth"),
             ("lab_separated", lab_separated, "separated"))
    out = {"lab_cios_fullwidth": {}, "lab_separated": {}}
    # raw digits reach the code that drops what passes the top
    ra, rb = raw_operands(F, 1 << 18)
    for name, counter, form in forms:
        before = counter.launches
        got = lab.kernel(form)(ra, rb)
        if counter.launches != before + 1:
            raise AssertionError(f"{name} on CUDA tensors did not launch its kernel")
        want = lab.body(form)(ra, rb)
        err = int((got.long() - want.long()).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"{name} != plain on raw digits at n={F.nlimbs}: max err {err}")
        out[name][f"raw_digits/{F.nlimbs}"] = fig = dict(
            nlimbs=F.nlimbs, cols=ra.shape[1], max_abs_err=err)
        line("lab_kernel", kernel=name, width="raw_digits", **fig)
    del ra, rb, got, want
    for label, cols in widths.items():
        a, b = operand_pair(F, cols, rng, True)
        a, b = a.to(dev), b.to(dev)
        b1 = F.mul(a, b)
        for name, counter, form in forms:
            fn, body = lab.kernel(form), lab.body(form)
            before = counter.launches
            got = fn(a, b)
            if counter.launches != before + 1:
                raise AssertionError(f"{name} on CUDA tensors did not launch its kernel")
            want = body(a, b)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(f"{name} != plain at n={F.nlimbs} width {label}: max err {err}")
            if not torch.equal(got, b1):
                raise AssertionError(f"{name} != B1 at n={F.nlimbs} width {label}")
            if label == next(iter(widths)):
                replay_check(fn, a, b, counter)
            ms = graph_ms(fn, a, b)
            eager_ms = cuda_ms(lambda: fn(a, b), 20)
            plain_ms = cuda_ms(lambda: body(a, b), 3)
            bound, bound_by = mont_mul_bound_ms(F.nlimbs, cols)
            out[name][f"{label}/{F.nlimbs}"] = fig = dict(
                nlimbs=F.nlimbs, cols=cols, max_abs_err=err, matches_b1=True, ms=ms,
                eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
            )
            line("lab_kernel", kernel=name, width=label, **fig)
        del a, b, b1
        torch.cuda.empty_cache()
    return out


def lab_phase(dev, counters) -> dict:
    """The lab entry points as one main-path run: every kernel count set to
    0 just before, read just after. fp_kernel_lab at batch 2^18 and 2^20,
    mxu_limb_lab at its batch 2^15, and the production field's marginal
    rate for cios and rns at 2^20. A failed validation or agreement gate
    exits there (SystemExit) and fails the run. Returns the figures."""
    from handel_tpu_torch.ops.fp import _throughput_bench
    from handel_tpu_torch.scripts import fp_kernel_lab, mxu_limb_lab

    zero_counts(counters)
    t0 = time.perf_counter()
    labs = {f"fp_kernel_lab/{batch}": fp_kernel_lab.main([str(batch)])
            for batch in (1 << 18, 1 << 20)}
    labs["mxu_limb_lab"] = mxu_limb_lab.main([])
    rates = {backend: _throughput_bench(1 << 20, backend=backend, device=dev)[0]
             for backend in ("cios", "rns")}
    launches = {k: c.launches for k, c in counters.items()}
    seconds = time.perf_counter() - t0
    for key, res in labs.items():
        if res["lab"] == "fp_kernel_lab":
            line("lab", lab=key, batch=res["batch"], muls_per_s=res["muls_per_s"],
                 replayed_calls=res["replayed_calls"],
                 max_memory_allocated=res["max_memory_allocated"])
            if any(v is None for v in res["muls_per_s"].values()):
                raise AssertionError(f"{key}: a candidate's slope was not measurable")
        else:
            line("lab", lab=key, **{k: v for k, v in res.items() if k not in ("lab", "device")})
            if any(res[k] is None for k in ("prod_muls_per_s", "outer8_muls_per_s", "rns_muls_per_s")):
                raise AssertionError(f"{key}: a candidate's slope was not measurable")
    line("lab", lab="ops.fp", batch=1 << 20, mont_muls_per_s=rates)
    if not all(rates.values()):
        raise AssertionError(f"ops.fp: a marginal rate was not measurable: {rates}")
    if launches["rns_mont_mul_resident"] != 0:
        raise AssertionError("the lab launched B2: the per-mul rns product never does")
    # the kernels B3a and B3b executed: a wrapper's count moves at eager calls
    # and at graph capture, never at replay, so take the captured calls out
    # and the replayed ones in
    captured, replayed, executed = {}, {}, {}
    for name, form in (("lab_cios_fullwidth", "cios_fullwidth"), ("lab_separated", "separated")):
        cands = [(res, cand) for key, res in labs.items() if key.startswith("fp_kernel_lab")
                 for cand in res["replayed_calls"] if cand.startswith(f"cuda:{form}:")]
        captured[name] = sum(res["captured_calls"][cand] for res, cand in cands)
        replayed[name] = sum(res["replayed_calls"][cand] for res, cand in cands)
        executed[name] = launches[name] - captured[name] + replayed[name]
        if executed[name] == 0:
            raise AssertionError(f"the lab never launched {name}")
    line("memory", path="lab", wrapper_counts=launches, captured_calls=captured,
         replayed_calls=replayed, executed=executed, seconds=seconds)
    return {"labs": labs, "rates": rates, "executed": executed, "captured": captured,
            "replayed": replayed}


def make_registry(n: int, rng: random.Random):
    """Registry keys from seeded small scalars (bench.py's keygen shape:
    device cost does not depend on the scalar size)."""
    from handel_tpu_torch.models.bn254 import BN254PublicKey
    from handel_tpu_torch.ops import bn254_ref as bn

    sks = [rng.randrange(1, 1 << 30) for _ in range(n)]
    return sks, [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks]


def make_requests(kind: str, sks, count: int, rng: random.Random):
    """`count` candidates of one launch class with the verdict each must get.

    range: contiguous partitioner ranges of n/8, n/4 or n/2 keys with up to
    8 holes (bench.py build_problem); dense: random quarter subsets
    (bench.py's dense phase). Lane 1 carries a wrong signature, lane 2 a
    signature over another message, lane 3 an empty bitset."""
    from handel_tpu_torch.core.bitset import BitSet
    from handel_tpu_torch.models.bn254 import BN254Signature, hash_to_g1
    from handel_tpu_torch.ops import bn254_ref as bn

    n = len(sks)
    h, h_other = hash_to_g1(MSG), hash_to_g1(MSG + b" (other)")
    requests, expect = [], []
    for j in range(count):
        if kind == "range":
            size = rng.choice([n // 8, n // 4, n // 2])
            lo = rng.randrange(0, n - size)
            holes = set(rng.sample(range(lo, lo + size), rng.randrange(0, 9)))
            signers = [i for i in range(lo, lo + size) if i not in holes]
        else:
            signers = rng.sample(range(n), n // 4)
        if j == 3:
            signers = []
        bs = BitSet(n)
        for i in signers:
            bs.set(i, True)
        agg = sum(sks[i] for i in signers) % bn.R
        point = bn.g1_mul(h_other if j == 2 else h, agg + (1 if j == 1 else 0))
        requests.append((bs, BN254Signature(point)))
        expect.append(j not in (1, 2, 3))
    return requests, expect


def pairing_phase(device, backend: str) -> None:
    """e(P, Q) on the card against the scalar oracle on two lanes (the
    resident pairing for the rns backend)."""
    from handel_tpu_torch.ops import bn254_ref as bn
    from handel_tpu_torch.ops.curve import BN254Curves
    from handel_tpu_torch.ops.pairing import BN254Pairing

    pr = BN254Pairing(BN254Curves(device=device, backend=backend))
    if pr.resident != (backend == "rns"):
        raise AssertionError(f"{backend} pairing resident={pr.resident}")
    F, T = pr.F, pr.T
    rng = random.Random(SEED)
    ps = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    qs = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    p = (F.pack([x[0] for x in ps]), F.pack([x[1] for x in ps]))
    q = (T.f2_pack([x[0] for x in qs]), T.f2_pack([x[1] for x in qs]))
    if T.f12_unpack(pr.pairing(p, q)) != [bn.pairing(b, a) for a, b in zip(ps, qs)]:
        raise AssertionError(f"{backend} pairing on the card != scalar oracle")
    line("pairing", backend=backend, resident=pr.resident, lanes=2, matches_oracle=True)


def profile_phase(cons, pks, requests, kernel: str, label: str, counter, bound) -> dict:
    """One verify launch under torch.profiler (device activity only): the
    kernels and copies it ran, the device's busy time against the wall time
    (the idle share, inflated by the profiler's own host cost), and the
    activities that took the most device time. For the path's kernel
    (`kernel` in its device name, `counter` its wrapper): its device ms in
    the launch against the sum of bound(cols) over the launch's calls, from
    the wrapper's width histogram. Returns the kernel's figures."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = dict(counter.widths)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cons.batch_verify(MSG, pks, requests)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not acts:
        raise AssertionError("torch.profiler recorded no device activity")
    by_name: dict[str, list] = {}
    for e in acts:
        entry = by_name.setdefault(e.name, [0, 0.0])
        entry[0] += 1
        entry[1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    ours = [v for k, v in by_name.items() if kernel in k]
    if not ours:
        raise AssertionError(f"the profiled launch ran no {kernel}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    calls = {cols: n - before.get(cols, 0) for cols, n in counter.widths.items()
             if n != before.get(cols, 0)}
    fig = {"count": sum(c for c, _ in ours), "ms": sum(ms for _, ms in ours),
           "calls_by_cols": {str(k): v for k, v in sorted(calls.items())},
           "bound_ms": sum(n * bound(cols)[0] for cols, n in calls.items())}
    line("profile", path=label, launch_class="range", wall_ms=wall_ms,
         device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
         device_activities=len(acts), **{kernel: fig},
         top=[{"name": k[:80], "count": c, "ms": ms} for k, (c, ms) in top])
    return fig


def zero_counts(counters) -> None:
    """Every kernel's launch count to 0, and B1's and B2's width histograms
    with it."""
    for c in counters.values():
        if hasattr(c, "reset"):
            c.reset()
        else:
            c.launches = 0


def width_histograms(counters) -> dict:
    """{kernel: {columns: launches}} for the wrappers that count widths and
    launched in the run."""
    return {k: {str(cols): n for cols, n in sorted(c.widths.items())}
            for k, c in counters.items() if getattr(c, "widths", None)}


def verify_path(label, cons, pks, reqs, counters, expect_launch, expect_idle, conv_field=None):
    """One main-path run of a verify path: prepare (registry commit, warmup
    and prefix table), then every kernel count set to 0, the range and dense
    launches with their verdicts checked, the counts read; then the timed
    launches. Returns {kernel: launches in the main-path run}."""
    import torch

    dev = cons.curves.device
    t0 = time.perf_counter()
    engine = cons.prepare(pks)  # registry commit + warmup launch (prefix table)
    torch.cuda.synchronize()
    line("prepare", path=label, seconds=time.perf_counter() - t0)
    for kind, (requests, _expect) in reqs.items():
        plan = engine._pack_requests(requests)
        if plan.kind != kind:
            raise AssertionError(f"{kind} requests packed as a {plan.kind} launch")

    # the main path: counts zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(counters)
    if conv_field is not None:
        conv_field.reset_conversion_counts()
    per_class = {}
    for kind, (requests, expect) in reqs.items():
        before = {k: c.launches for k, c in counters.items()}
        got = cons.batch_verify(MSG, pks, requests)
        per_class[kind] = {k: c.launches - before[k] for k, c in counters.items()}
        if got != expect:
            bad = [j for j, (g, e) in enumerate(zip(got, expect)) if g != e]
            raise AssertionError(f"{label} {kind} verdicts wrong at lanes {bad}")
    launches = {k: c.launches for k, c in counters.items()}
    widths = width_histograms(counters)
    conv = conv_field.conversion_counts() if conv_field is not None else None
    if launches[expect_launch] == 0:
        raise AssertionError(f"the {label} path never launched {expect_launch}")
    for k in expect_idle:
        if launches[k] != 0:
            raise AssertionError(f"the {label} path launched {k} {launches[k]} times")
    peak = torch.cuda.max_memory_allocated(dev)
    for kind, (requests, _expect) in reqs.items():
        walls = []
        for _ in range(TIMED_LAUNCHES):
            t0 = time.perf_counter()
            cons.batch_verify(MSG, pks, requests)
            walls.append((time.perf_counter() - t0) * 1e3)
        line("verify", path=label, launch_class=kind, lanes=LANES,
             candidates=len(requests), registry=N_REGISTRY, verdicts_ok=True,
             p50_ms=statistics.median(walls), wall_ms=walls,
             launches_per_verify=per_class[kind])
    line("memory", path=label, max_memory_allocated=peak, launches=launches,
         conversion_counts=conv)
    line("widths", path=label, launches_by_cols=widths)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from handel_tpu_torch.kernels import build
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.kernels.lab_mont import lab_cios_fullwidth, lab_separated
    from handel_tpu_torch.kernels.rns_mont import SUPPORTED_BASES as RNS_BASES
    from handel_tpu_torch.kernels.rns_mont import TILES as RNS_TILES
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident
    from handel_tpu_torch.models.bn254_torch import BN254TorchScheme
    from handel_tpu_torch.ops import bn254_ref as bn
    from handel_tpu_torch.ops.fp import Field

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    line("device", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for src, (_secs, log) in built.items():
        ptxas[src] = ptxas_summary(log)
        for fn, (regs, st, ld, smem) in ptxas[src].items():
            print(f"  nvcc {src}: {fn}: {regs} registers, {st} bytes spill stores, "
                  f"{ld} bytes spill loads, {smem} bytes static shared memory")
    # kernel B2: its tiles' dynamic shared memory, and its int8 tensor-core
    # products (IMMA) in the built SASS; every B1 and B2 instance spill-free
    import ctypes

    smem_of = ctypes.CDLL(str(build.library_path("rns_mont"))).handel_rns_smem_bytes
    dyn_smem = {f"rns_mul_resident_kernel<{ka},{kb},{tile}>": smem_of(ka, kb, tile)
                for ka, kb in RNS_BASES for tile in RNS_TILES}
    imma = {k: n for k, n in sass_counts(build.library_path("rns_mont"), "IMMA").items()
            if k.startswith("rns_mul_resident_kernel")}
    line("build", seconds=seconds, sources=sorted(built), ptxas=ptxas,
         dynamic_smem=dyn_smem, imma=imma)
    if sorted(imma) != sorted(dyn_smem) or not all(imma.values()):
        raise AssertionError(f"a B2 instance without IMMA instructions: {imma}")
    for src in ("fp_mont", "rns_mont"):
        if not ptxas[src]:
            raise AssertionError(f"no ptxas report for {src}: spills cannot be checked")
        for fn, (_regs, st, ld, _smem) in ptxas[src].items():
            if st or ld:
                raise AssertionError(f"{fn} spills ({st} bytes stored, {ld} loaded)")

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    F16 = Field(bn.P, device=dev)
    F24 = Field(BLS12_381_P, device=dev)
    f12_width = 54 * 2 * LANES  # f12_mul over the 2C Miller lanes of a launch
    # the dense class's first tree-sum stage adds two halves of N*C points;
    # its second stacked multiply is 6 Fp2 products, 3 base products each
    widest = 9 * N_REGISTRY * LANES
    R46 = Field(bn.P, backend="rns", device=dev)
    R65 = Field(BLS12_381_P, backend="rns", device=dev)
    ragged_phase((F16, F24), (R46, R65), rng)
    k16 = kernel_phase(
        F16, {"random+edges": (1 << 20) + 16, "f12_mul": f12_width, "g2_add_dense": widest},
        rng, with_edges=True,
    )
    k24 = kernel_phase(F24, {"random+edges": (1 << 20) + 16}, rng, with_edges=True)
    r46 = rns_kernel_phase(R46, {"random+edges": (1 << 20) + 16, "f12_mul": f12_width}, rng)
    r65 = rns_kernel_phase(R65, {"random+edges": (1 << 20) + 16}, rng)
    b3 = lab_kernel_phase(
        F16, {"random+edges": (1 << 20) + 16, "lab_batch": 1 << 18, "f12_mul": f12_width}, rng
    )
    b3_24 = lab_kernel_phase(F24, {"random+edges": (1 << 20) + 16}, rng)
    for kname in b3:
        b3[kname].update(b3_24[kname])

    pairing_phase(dev, "cios")
    pairing_phase(dev, "rns")

    prng = random.Random(SEED)
    t0 = time.perf_counter()
    sks, pks = make_registry(N_REGISTRY, prng)
    reqs = {
        "range": make_requests("range", sks, RANGE_CANDIDATES, prng),
        "dense": make_requests("dense", sks, DENSE_CANDIDATES, prng),
    }
    line("setup", registry=N_REGISTRY, host_keygen_s=time.perf_counter() - t0)
    counters = {"fp_mont_mul": mont_mul, "rns_mont_mul_resident": rns_mul_resident,
                "lab_cios_fullwidth": lab_cios_fullwidth, "lab_separated": lab_separated}
    cons = BN254TorchScheme(batch_size=LANES, device=dev).constructor
    cios = verify_path("cios", cons, pks, reqs, counters, "fp_mont_mul",
                       ("rns_mont_mul_resident", "lab_cios_fullwidth", "lab_separated"))
    rcons = BN254TorchScheme(batch_size=LANES, device=dev, fp_backend="rns").constructor
    rns = verify_path("rns", rcons, pks, reqs, counters, "rns_mont_mul_resident",
                      ("fp_mont_mul", "lab_cios_fullwidth", "lab_separated"),
                      conv_field=rcons.curves.F)
    on_path = {
        "fp_mont_mul": profile_phase(cons, pks, reqs["range"][0], "mont_mul_kernel", "cios",
                                     mont_mul, lambda c: mont_mul_bound_ms(16, c)),
        "rns_mont_mul_resident": profile_phase(
            rcons, pks, reqs["range"][0], "rns_mul_resident_kernel", "rns", rns_mul_resident,
            lambda c: rns_bound_ms(rcons.curves.F, c)),
    }
    lab = lab_phase(dev, counters)

    def entry(kname, source, replaces, launches, widths, fig, **extra):
        return {
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in widths),
            "ms": fig["ms"], "eager_ms": fig["eager_ms"], "plain_ms": fig["plain_ms"],
            "bound_ms": fig["bound_ms"], "bound_by": fig["bound_by"],
            "library_ms": None, "cols": fig["cols"], **extra,
        }

    # B1 and B2 at the Fp12 width of their verify path, with their launches
    # there; B3a and B3b at 2^20 + 16 columns of 16 limbs, with the launches
    # they executed in the lab run (captured calls beside them)
    print(json.dumps({"kernels": [
        entry("fp_mont_mul", "handel_tpu_torch/csrc/fp_mont.cu", "handel_tpu/ops/fp.py:577",
              cios["fp_mont_mul"], [*k16.values(), *k24.values()], k16["f12_mul"],
              on_path_range_launch=on_path["fp_mont_mul"]),
        entry("rns_mont_mul_resident", "handel_tpu_torch/csrc/rns_mont.cu",
              "handel_tpu/ops/rns.py:571", rns["rns_mont_mul_resident"],
              [*r46.values(), *r65.values()], r46["f12_mul"],
              on_path_range_launch=on_path["rns_mont_mul_resident"]),
        *(entry(kname, "handel_tpu_torch/csrc/lab_mont.cu", "scripts/fp_kernel_lab.py:234",
                lab["executed"][kname], list(b3[kname].values()), b3[kname]["random+edges/16"],
                captured_calls=lab["captured"][kname], replayed_calls=lab["replayed"][kname])
          for kname in ("lab_cios_fullwidth", "lab_separated")),
    ]}))
    line("total", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
