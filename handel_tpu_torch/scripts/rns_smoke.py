"""RNS-backend gate — counterpart of scripts/rns_smoke.py.

The reference's checks that hold the port's rns field backend, each a hard
failure:

1. Bit-exactness: a seeded batch of products (random and edge operands,
   both at p - 1 among them) through `Field(backend="rns")` matches the
   bigint oracle and, at the canonical boundary, the cios field bit for bit
   (their Montgomery constants differ: R = 2^16n against the base-A
   product M).
2. CRT round trip: to_rns, then from_rns_base_b, is exact over the whole
   16n-bit positional range (the top value 2^256 - 1 takes the redundant
   channel's offset recovery to its limit).
3. Backend plumbing: fp_backend survives a TOML load and dump, junk values
   are refused, and it reaches the constructed Field through new_scheme
   (TOML, SimConfig, the scheme's arguments, Curves, Field).
5. Residue-resident conversion count: one resident pairing crosses the
   CRT boundary O(line boundaries) times (points in, f12 out: 8 or fewer),
   the per-mul form once per tower multiply (counted as the port runs it,
   eagerly: an order of magnitude more).
6. Resident tower bit-exactness: a seeded batch through the resident
   `f12_mul` (residue planes in, CRT out) matches the scalar oracle and the
   per-mul tower at the canonical boundary.

The reference's checks 4 and 7 are bench gates (scripts/bench_check.py
`--dry-run` over `mont_muls_per_s` and `pairing_p50_ms` records keyed per
fp_backend): they come with the port's benchmark (ROADMAP item 10a).

`--full` also runs the resident pairing against the scalar oracle, and the
batched `pairing_check` on a valid and a forged candidate.

    python -m handel_tpu_torch.scripts.rns_smoke [--device cpu] [--full]
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import tempfile

import numpy as np
import torch

from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.fp import Field
from handel_tpu_torch.utils.torchenv import resolve_device


def check_bit_exact(dev) -> None:
    Fr = Field(bn.P, backend="rns", device=dev)
    Fc = Field(bn.P, device=dev)
    rng = np.random.default_rng(2024)
    xs = [int.from_bytes(rng.bytes(32), "little") % bn.P for _ in range(12)]
    xs += [0, 1, bn.P - 1, bn.P - 1]
    ys = list(reversed(xs))

    got = Fr.unpack(Fr.mul(Fr.pack(xs), Fr.pack(ys)))
    assert got == [x * y % bn.P for x, y in zip(xs, ys)], (
        "rns mul disagrees with the bigint oracle")

    # the canonical-boundary limbs bitwise equal to the cios field's
    plain = Fr.pack(xs, mont=False)
    assert torch.equal(plain, Fc.pack(xs, mont=False)), "canonical pack differs between backends"
    out_r = Fr.from_mont(Fr.mul(Fr.to_mont(plain), Fr.to_mont(plain)))
    out_c = Fc.from_mont(Fc.mul(Fc.to_mont(plain), Fc.to_mont(plain)))
    assert torch.equal(out_r, out_c), "boundary limbs not bit-identical between rns and cios"
    print(f"rns_smoke: bit-exact vs cios over {len(xs)} seeded products")


def check_crt_roundtrip(dev) -> None:
    F = Field(bn.P, backend="rns", device=dev)
    n = F.nlimbs
    tops = [(1 << (16 * n)) - 1, bn.P, bn.P + 1, 12345, 0]
    arr = np.zeros((n, len(tops)), np.int32)
    for j, v in enumerate(tops):
        for i in range(n):
            arr[i, j] = (v >> (16 * i)) & 0xFFFF
    r = F.to_rns(torch.from_numpy(arr).to(dev))
    v16 = F.from_rns_base_b(r[F.kA : F.kA + F.kB], r[F.kA + F.kB]).cpu().numpy()
    for j, v in enumerate(tops):
        rec = sum(int(v16[i, j]) << (16 * i) for i in range(F.n16out))
        assert rec == v, f"CRT round-trip broke at {v:#x}"
    print(f"rns_smoke: CRT round-trip exact over {len(tops)} values "
          f"(top {tops[0].bit_length()} bits)")


def check_toml_plumbing(dev) -> None:
    from handel_tpu_torch.models.registry import new_scheme
    from handel_tpu_torch.ops.rns import RnsField
    from handel_tpu_torch.sim.config import dump_config, load_config

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cfg.toml")
        with open(path, "w") as f:
            f.write('scheme = "bn254-cuda"\nfp_backend = "rns"\n'
                    '[service]\nfp_backend = "cios"\n')
        cfg = load_config(path)
        assert cfg.fp_backend == "rns"
        assert cfg.service.fp_backend == "cios"
        assert 'fp_backend = "rns"' in dump_config(cfg)
        bad = os.path.join(d, "bad.toml")
        with open(bad, "w") as f:
            f.write('fp_backend = "vpu"\n')
        try:
            load_config(bad)
        except ValueError:
            pass
        else:
            raise AssertionError("junk fp_backend accepted")
    sch = new_scheme("bn254-cuda", batch_size=4, mesh_devices=1, fp_backend="rns",
                     warmup=False, device=dev)
    F = sch.constructor.curves.F
    assert type(F) is RnsField and F.backend == "rns"
    print("rns_smoke: fp_backend plumbed TOML -> SimConfig -> Field")


def _pairing_stack(dev):
    """One rns curve and pairing stack shared by the resident checks: the
    resident pairing and the per-mul one."""
    from handel_tpu_torch.ops.curve import BN254Curves
    from handel_tpu_torch.ops.pairing import BN254Pairing

    curves = BN254Curves(device=dev, backend="rns")
    return curves, BN254Pairing(curves), BN254Pairing(curves, resident=False)


def check_resident_conversions(stack) -> None:
    curves, pr, legacy = stack
    F = curves.F
    B = 4
    p = (F.pack([bn.G1_GEN[0]] * B), F.pack([bn.G1_GEN[1]] * B))
    q = (curves.T.f2_pack([bn.G2_GEN[0]] * B), curves.T.f2_pack([bn.G2_GEN[1]] * B))

    F.reset_conversion_counts()
    pr.pairing(p, q)
    res = F.conversion_counts()["total"]
    F.reset_conversion_counts()
    legacy.pairing(p, q)
    leg = F.conversion_counts()["total"]
    F.reset_conversion_counts()
    assert res <= 8, (
        f"resident pairing crossed the CRT boundary {res} times: expected "
        "O(line boundaries) (points in + f12 out)")
    assert leg >= 10 * res, (
        f"the per-mul pairing converted only {leg} times against the resident {res}: "
        "its per-mul round trip should dominate by an order of magnitude")
    print(f"rns_smoke: resident pairing converts {res}x (per-mul form: {leg}x)")


def check_resident_tower_bit_exact(stack) -> None:
    curves, _, _ = stack
    rng = random.Random(1606)

    def rand_f12():
        return tuple(tuple((rng.randrange(bn.P), rng.randrange(bn.P)) for _ in range(3))
                     for _ in range(2))

    a_vals = [rand_f12() for _ in range(4)]
    b_vals = [rand_f12() for _ in range(4)]
    # operands at p - 1 take the bound walk right to the modulus
    a_vals[0] = tuple(tuple((bn.P - 1, bn.P - 1) for _ in range(3)) for _ in range(2))
    b_vals[0] = a_vals[0]

    Tr = curves.T.as_resident()
    got = Tr.f12_unpack(Tr.f12_mul(Tr.f12_pack(a_vals), Tr.f12_pack(b_vals)))
    assert got == [bn.f12_mul(x, y) for x, y in zip(a_vals, b_vals)], (
        "resident f12_mul disagrees with the scalar oracle")
    Tc = curves.T
    got_c = Tc.f12_unpack(Tc.f12_mul(Tc.f12_pack(a_vals), Tc.f12_pack(b_vals)))
    assert got == got_c, "resident and per-mul towers disagree at the canonical boundary"
    print("rns_smoke: resident f12_mul bit-exact vs oracle + per-mul tower over "
          f"{len(a_vals)} lanes (all-(p-1) operands among them)")


def check_resident_pairing_full(stack) -> None:
    """--full only: the resident pairing against the scalar oracle, and the
    batched product check on a valid and a forged candidate."""
    curves, pr, _ = stack
    rng = random.Random(16)
    B = 4
    F, T = curves.F, curves.T
    g1s = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(B)]
    g2s = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(B)]
    p = (F.pack([pt[0] for pt in g1s]), F.pack([pt[1] for pt in g1s]))
    q = (T.f2_pack([pt[0] for pt in g2s]), T.f2_pack([pt[1] for pt in g2s]))
    got = T.f12_unpack(pr.pairing(p, q))
    assert got == [bn.pairing(q_, p_) for p_, q_ in zip(g1s, g2s)], (
        "resident pairing disagrees with the oracle")
    print(f"rns_smoke[full]: resident pairing == oracle over {B} seeded lanes")

    h = bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R))
    sks = [rng.randrange(1, bn.R) for _ in range(2)]
    pks = [bn.g2_mul(bn.G2_GEN, sk) for sk in sks]
    sigs = [bn.g1_mul(h, sks[0]), bn.g1_mul(h, sks[1] + 1)]  # lane 1 forged
    g1s = [h, h, bn.g1_neg(sigs[0]), bn.g1_neg(sigs[1])]
    g2s = [pks[0], pks[1], bn.G2_GEN, bn.G2_GEN]
    p = (F.pack([pt[0] for pt in g1s]), F.pack([pt[1] for pt in g1s]))
    q = (T.f2_pack([pt[0] for pt in g2s]), T.f2_pack([pt[1] for pt in g2s]))
    mask = torch.ones((4,), dtype=torch.bool, device=F.device)
    ok = pr.pairing_check(p, q, mask, 2).tolist()
    assert ok == [True, False], "resident pairing_check verdicts wrong on valid+forged candidates"
    print("rns_smoke[full]: resident pairing_check accepts valid / rejects forged")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="also the resident pairing against the oracle")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    check_bit_exact(dev)
    check_crt_roundtrip(dev)
    check_toml_plumbing(dev)
    stack = _pairing_stack(dev)
    check_resident_conversions(stack)
    check_resident_tower_bit_exact(stack)
    if args.full:
        check_resident_pairing_full(stack)
    print("rns_smoke: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
