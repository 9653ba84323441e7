#!/usr/bin/env python3
"""Bring-up check of the PyTorch + CUDA port (handel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero with no result line:

  1. device   the card's name, and its name and power limit from nvidia-smi
  2. build    nvcc builds every kernel source of the port (csrc/*.cu), one
              process per source, all at once
  3. kernel   kernel B1, the Montgomery multiply (Field.mul on CUDA tensors),
              against its plain PyTorch version on the card, exact equality,
              for BN254 (16 limbs) and BLS12-381 (24 limbs): 2^20 seeded
              random columns plus edge columns, and the widths the verify
              path gives it (an Fp12 multiply at 128 lanes; the widest
              stacked G2 add of the dense class); kernel and plain times
     rns_kernel  kernel B2, the resident RNS Montgomery multiply
              (RnsField.mul_resident on CUDA tensors), against its plain
              version, exact equality, for BN254 (k_all 46) and BLS12-381
              (k_all 65): 2^20 + 16 random residue columns with 0 and m_i - 1
              first, and an Fp12 multiply at 128 lanes; the integer identity
              x y M^-1 mod p through the resident conversions on a prefix
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
              resident pairing against the scalar oracle
  5. profile  one range launch of each path under torch.profiler: device
              activities, busy time against wall time, the costliest kernels

Each path of phase 4 is one main-path run: every kernel's launch count is
set to 0 just before it and read just after. Then one JSON line of kernel
figures, the nvidia-smi line again, and last {"ok": true, "device": {...}}.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import random
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

    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident

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
        ms = cuda_ms(lambda: F.mul_resident(a, b), 20)
        plain_ms = cuda_ms(lambda: F._mul_resident_core(a, b), 3)
        bound, bound_by = rns_bound_ms(F, cols)
        out[label] = dict(
            k_all=F.k_all, cols=cols, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by,
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


def kernel_phase(F, widths: dict[str, int], rng, with_edges: bool) -> dict:
    """Kernel against the plain version on the card at each width; returns
    per-width figures. Raises on any difference."""
    import torch

    from handel_tpu_torch.kernels.fp_mont import mont_mul

    dev = F.device
    out = {}
    for label, cols in widths.items():
        a = random_columns(F, cols, rng)
        b = random_columns(F, cols, rng)
        if with_edges:  # every pair of 0, 1, p-1, R mod p in the first columns
            edges = [0, 1, F.p - 1, F.mont_r]
            ea = F.pack_batch_np([x for x in edges for _ in edges], mont=False)
            eb = F.pack_batch_np([y for _ in edges for y in edges], mont=False)
            a[:, : ea.shape[1]] = torch.from_numpy(ea)
            b[:, : eb.shape[1]] = torch.from_numpy(eb)
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
        ms = cuda_ms(lambda: F.mul(a, b), 20 if cols <= 1 << 20 else 5)
        plain_ms = cuda_ms(lambda: F._mul_plain(a, b), 3)
        bound, bound_by = mont_mul_bound_ms(F.nlimbs, cols)
        out[label] = dict(
            nlimbs=F.nlimbs, cols=cols, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by, launches=mont_mul.launches - before,
        )
        line("kernel", **out[label], width=label)
        del a, b, got, want
        torch.cuda.empty_cache()
    return out


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


def profile_phase(cons, pks, requests, kernel: str, label: str) -> None:
    """One verify launch under torch.profiler (device activity only): the
    kernels and copies it ran, the device's busy time against the wall time
    (the idle share, inflated by the profiler's own host cost), and the
    activities that took the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    line("profile", path=label, launch_class="range", wall_ms=wall_ms,
         device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
         device_activities=len(acts),
         **{kernel: {"count": sum(c for c, _ in ours), "ms": sum(ms for _, ms in ours)}},
         top=[{"name": k[:80], "count": c, "ms": ms} for k, (c, ms) in top])


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
    for c in counters.values():
        c.launches = 0
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
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from handel_tpu_torch.kernels import build
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident
    from handel_tpu_torch.models.bn254_torch import BN254TorchScheme
    from handel_tpu_torch.ops import bn254_ref as bn
    from handel_tpu_torch.ops.fp import Field

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    line("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = build.build_all()
    for src, (_secs, log) in built.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  nvcc {src}: {ln.strip()}")
    line("build", seconds=time.perf_counter() - t0, sources=sorted(built))

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    F16 = Field(bn.P, device=dev)
    F24 = Field(BLS12_381_P, device=dev)
    f12_width = 54 * 2 * LANES  # f12_mul over the 2C Miller lanes of a launch
    # the dense class's first tree-sum stage adds two halves of N*C points;
    # its second stacked multiply is 6 Fp2 products, 3 base products each
    widest = 9 * N_REGISTRY * LANES
    k16 = kernel_phase(
        F16, {"random+edges": (1 << 20) + 16, "f12_mul": f12_width, "g2_add_dense": widest},
        rng, with_edges=True,
    )
    k24 = kernel_phase(F24, {"random+edges": (1 << 20) + 16}, rng, with_edges=True)
    R46 = Field(bn.P, backend="rns", device=dev)
    R65 = Field(BLS12_381_P, backend="rns", device=dev)
    r46 = rns_kernel_phase(R46, {"random+edges": (1 << 20) + 16, "f12_mul": f12_width}, rng)
    r65 = rns_kernel_phase(R65, {"random+edges": (1 << 20) + 16}, rng)

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
    counters = {"fp_mont_mul": mont_mul, "rns_mont_mul_resident": rns_mul_resident}
    cons = BN254TorchScheme(batch_size=LANES, device=dev).constructor
    cios = verify_path("cios", cons, pks, reqs, counters, "fp_mont_mul",
                       ("rns_mont_mul_resident",))
    rcons = BN254TorchScheme(batch_size=LANES, device=dev, fp_backend="rns").constructor
    rns = verify_path("rns", rcons, pks, reqs, counters, "rns_mont_mul_resident",
                      ("fp_mont_mul",), conv_field=rcons.curves.F)
    profile_phase(cons, pks, reqs["range"][0], "mont_mul_kernel", "cios")
    profile_phase(rcons, pks, reqs["range"][0], "rns_mul_resident_kernel", "rns")

    b1, b2 = k16["f12_mul"], r46["f12_mul"]
    print(json.dumps({"kernels": [
        {
            "name": "fp_mont_mul",
            "route": "cuda",
            "source": "handel_tpu_torch/csrc/fp_mont.cu",
            "replaces": "handel_tpu/ops/fp.py:577",
            "launches": cios["fp_mont_mul"],
            "max_abs_err": max(r["max_abs_err"] for r in [*k16.values(), *k24.values()]),
            "ms": b1["ms"],
            "plain_ms": b1["plain_ms"],
            "bound_ms": b1["bound_ms"],
            "bound_by": b1["bound_by"],
            "library_ms": None,
        },
        {
            "name": "rns_mont_mul_resident",
            "route": "cuda",
            "source": "handel_tpu_torch/csrc/rns_mont.cu",
            "replaces": "handel_tpu/ops/rns.py:571",
            "launches": rns["rns_mont_mul_resident"],
            "max_abs_err": max(r["max_abs_err"] for r in [*r46.values(), *r65.values()]),
            "ms": b2["ms"],
            "plain_ms": b2["plain_ms"],
            "bound_ms": b2["bound_ms"],
            "bound_by": b2["bound_by"],
            "library_ms": None,
        },
    ]}))
    line("total", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
