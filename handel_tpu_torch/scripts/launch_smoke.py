"""Launch-path smoke: 8 packed launches and the batched combine —
counterpart of scripts/launch_smoke.py.

Drives the engine's staged launch path (models/bn254_torch.py): 8 launches
of C = 4 range candidates over a 12-key registry, each through the
vectorized packer, the rotating staging sets, the copy to the device, the
range aggregation (prefix gather and hole patch) and the pairing tail, with
the host pack and dispatch split counted as the engine's dispatch counts
it. Every aggregate key is held against the host oracle and every verdict
against the one known by construction (lane 1 of each launch signs with a
scalar off by one). Then `combine_batch` is held against host folds.

The reference drives only the aggregation stage, since its pairing tail
takes minutes of XLA on one CPU core; the port's eager launch runs whole on
the CPU. The reference's fleet parametrization (the same aggregation on a
plane of 8 engines) is the port's multichip_smoke phase 1, and its last
step, a host-pipeline bench artifact checked by `scripts/bench_check.py
--dry-run`, is a bench gate: it comes with the port's benchmark (ROADMAP
item 10a).

    python -m handel_tpu_torch.scripts.launch_smoke [--device cpu] [--launches 8]
"""

from __future__ import annotations

import argparse
import random
import sys
import time

import numpy as np

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.models.bn254 import BN254PublicKey, BN254Signature, hash_to_g1
from handel_tpu_torch.models.bn254_torch import BN254Device
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.utils.torchenv import resolve_device

N, C, LAUNCHES = 12, 4, 8
MSG = b"launch smoke"


def host_agg(pks, bs):
    acc = None
    for i in bs.indices():
        acc = pks[i].point if acc is None else bn.g2_add(acc, pks[i].point)
    return acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--launches", type=int, default=LAUNCHES)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = random.Random(99)
    sks = [rng.randrange(1, 1 << 20) for _ in range(N)]
    pks = [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks]
    device = BN254Device(pks, batch_size=C, device=dev)
    h = hash_to_g1(MSG)
    h_x, h_y = device._h_point(MSG)
    device.reset_host_counters()

    # -- the packed launches through the staged path --------------------------
    t0 = time.perf_counter()
    checked = 0
    for launch in range(args.launches):
        reqs, expect = [], []
        for j in range(C):
            size = rng.randrange(2, N)
            lo = rng.randrange(0, N - size + 1)
            holes = set(rng.sample(range(lo + 1, lo + size - 1), min(2, size - 2)))
            bs = BitSet(N)
            for i in range(lo, lo + size):
                if i not in holes:
                    bs.set(i, True)
            k = sum(sks[i] for i in bs.indices()) + (1 if j == 1 else 0)
            reqs.append((bs, BN254Signature(bn.g1_mul(h, k % bn.R))))
            expect.append(j != 1)
        tp = time.perf_counter()
        plan = device._pack_requests(reqs)
        td = time.perf_counter()
        device.host_pack_ms += (td - tp) * 1000.0
        device.host_pack_launches += 1
        assert plan.kind == "range", plan.kind
        lo_t, hi_t, miss_idx, miss_ok, sig_x, sig_y, valid = device._issue(
            device._stage_plan, plan)
        bank = device.bank
        agg = device._issue(device._range_aggregate, lo_t, hi_t, miss_idx, miss_ok,
                            device._prefix, bank.reg_x, bank.reg_y, plan.miss_k)
        verdicts = device._issue(device._pairing_tail, agg, sig_x, sig_y, h_x, h_y, valid)
        device.host_dispatch_ms += (time.perf_counter() - td) * 1000.0
        device.host_dispatch_launches += 1
        x, y, inf = device.curves.g2.to_affine(agg)
        xs = device.curves.T.f2_unpack(x)
        ys = device.curves.T.f2_unpack(y)
        infs = np.asarray(inf.cpu())
        for j, (bs, _) in enumerate(reqs):
            got = None if infs[j] else (xs[j], ys[j])
            assert got == host_agg(pks, bs), f"launch {launch} lane {j}: aggregate mismatch"
            checked += 1
        got_v = [bool(v) for v in verdicts.cpu().tolist()]
        assert got_v == expect, f"launch {launch}: verdicts {got_v} != {expect}"
    assert device.host_pack_launches == args.launches
    assert device.host_dispatch_ms > 0.0
    print(
        f"launch_smoke: {args.launches} launches on {dev}, {checked} "
        f"aggregates and verdicts checked in {time.perf_counter() - t0:.1f}s (pack "
        f"{device.host_pack_ms / args.launches:.3f} ms/launch, dispatch "
        f"{device.host_dispatch_ms / args.launches:.3f} ms/launch)"
    )

    # -- the batched combine against host folds -------------------------------
    pts = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(8)]
    groups = [[rng.choice(pts) for _ in range(rng.randrange(2, 7))] for _ in range(2 * C)]
    got = device.combine_batch(groups)
    for g, out in zip(groups, got):
        acc = g[0]
        for p in g[1:]:
            acc = bn.g1_add(acc, p)
        assert out == acc, "combine_batch mismatch vs host fold"
    print(f"launch_smoke: combine_batch verified on {len(groups)} groups")
    return 0


if __name__ == "__main__":
    sys.exit(main())
