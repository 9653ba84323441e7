"""RLC batch-verification smoke — counterpart of scripts/rlc_smoke.py.

Holds the random-linear-combination batch check (models/rlc.py and its
wiring in HostDevice and BN254Device) to the reference smoke's checks: RLC
verdicts equal per-candidate verdicts on valid and forged batches, for both
launch shapes the service dispatches (single-message and mixed-message
`dispatch_multi`), with the pairing cost of a launch at M+1 Miller loops
and 1 final exponentiation by the RlcStats counters (against the 2C / C of
per-candidate checks). A forged batch comes back with exactly the
per-candidate culprit set, found by bisection. BLS12-381 goes through the
same host ops seam. Then the engine: an rlc-mode `BN254Device` packs range
and dense candidates into their classes and routes both through its RLC
launch.

As in the reference, the checks run on the host-math engine (the combined
check's equation, grouping, bisection and counters are the code the
engine shares through models/rlc.py), and the engine's side is held to
the dispatch seam; the engine's RLC launches are held by
tests/test_torch_rlc_device.py on the CPU and by `chip_smoke.py` phase 10
on the card, in place of the reference's optional
HANDEL_TPU_RLC_SMOKE_DEVICE phase. The reference's host bench
(`rlc_speedup_x` >= 3 at batch 64) and its `scripts/bench_check.py
--dry-run` self-test are bench gates: they come with the port's benchmark
(ROADMAP item 10a). `--candidates` cuts the host launches' batch (the
port's scalar oracle computes every pairing in Python).

    python -m handel_tpu_torch.scripts.rlc_smoke [--device cpu] [--candidates N]
"""

from __future__ import annotations

import argparse
import random
import sys
import time

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.models import rlc
from handel_tpu_torch.models.bn254 import BN254Scheme
from handel_tpu_torch.service.driver import HostDevice
from handel_tpu_torch.utils.torchenv import resolve_device

N = 16  # registry size
C = 64  # candidates per launch (the reference's batch)
M = 4  # distinct messages in the mixed-message launch


def build_batch(scheme, keys, pubs, rng, messages, c, forged=()):
    """c candidates over `messages` distinct messages; indices in `forged`
    carry a wrong-message aggregate signature."""
    from handel_tpu_torch.sim.adversary import forged_signature

    items = []
    for j in range(c):
        msg = messages[j % len(messages)]
        bs = BitSet(N)
        sig = None
        for i in rng.sample(range(N), rng.randrange(2, 6)):
            bs.set(i)
            s = forged_signature(keys[i][0], msg) if j in forged else keys[i][0].sign(msg)
            sig = s if sig is None else sig.combine(s)
        items.append((msg, pubs, bs, sig))
    return items


def check_parity(scheme, items, label):
    """RLC verdicts == per-candidate verdicts; returns both stat blocks."""
    pc = HostDevice(scheme.constructor)
    v_pc = pc.fetch(pc.dispatch_multi(items))
    dev = HostDevice(scheme.constructor, batch_check="rlc", rlc_rng=random.Random(1717))
    v_rlc = dev.fetch(dev.dispatch_multi(items))
    assert v_rlc == v_pc, f"{label}: verdict mismatch {v_rlc} != {v_pc}"
    return v_rlc, dev.rlc_stats, pc.rlc_stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu, for the engine")
    ap.add_argument("--candidates", type=int, default=C,
                    help="candidates per host launch (the scalar oracle's pairings "
                         "take most of the run)")
    args = ap.parse_args(argv)
    c = args.candidates
    dev_type = resolve_device(args.device)

    t0 = time.perf_counter()
    rng = random.Random(0x51C)
    scheme = BN254Scheme()
    keys = [scheme.keygen(i) for i in range(N)]
    pubs = [pk for _, pk in keys]
    single = [b"rlc-smoke-single"]
    multi = [f"rlc-smoke-{m}".encode() for m in range(M)]

    # -- valid batches: one combined check, M+1 Miller loops, 1 final exp --
    for msgs, label in ((single, "single-message"), (multi, "mixed-message")):
        items = build_batch(scheme, keys, pubs, rng, msgs, c)
        v, st, pst = check_parity(scheme, items, label)
        assert all(v), f"{label}: valid batch rejected"
        m = len(msgs)
        assert st.rlc_launches == 1 and st.bisection_ct == 0, st
        assert st.miller_lanes == m + 1, (
            f"{label}: {st.miller_lanes} Miller lanes, want M+1 = {m + 1}")
        assert st.final_exp_lanes == 1, st
        # the per-candidate baseline the RLC launch replaces: 2C / C
        assert pst.miller_lanes == 2 * c and pst.final_exp_lanes == c, pst
        print(f"rlc_smoke: {label} valid batch of {c}: verdict parity, "
              f"{st.miller_lanes} Miller loops + {st.final_exp_lanes} final exp "
              f"(per-candidate: {pst.miller_lanes} + {pst.final_exp_lanes})")

    # -- forged batches: bisection isolates the exact culprit set ----------
    for msgs, label in ((single, "single-message"), (multi, "mixed-message")):
        culprits = set(rng.sample(range(c), 3))
        items = build_batch(scheme, keys, pubs, rng, msgs, c, forged=culprits)
        v, st, _ = check_parity(scheme, items, label)
        found = {j for j, ok in enumerate(v) if not ok}
        assert found == culprits, f"{label}: isolated {found} != {culprits}"
        assert st.rlc_launches == 1 and st.bisection_ct > 0, st
        assert st.bisection_depth_max >= 1, st
        print(f"rlc_smoke: {label} forged batch: bisection isolated {sorted(culprits)} "
              f"in {st.bisection_ct} rechecks (depth {st.bisection_depth_max})")

    # -- BLS12-381 through the same host ops seam (small: scalar-oracle math)
    from handel_tpu_torch.models.bls12_381 import BLS12381Scheme

    bscheme = BLS12381Scheme()
    bkeys = [bscheme.keygen(i) for i in range(4)]
    bops = rlc.host_ops_for(bscheme.constructor)
    bcands = []
    for j, msg in enumerate((b"bls-a", b"bls-b")):
        sk, pk = bkeys[j]
        bcands.append((msg, pk.point, sk.sign(msg).point))
    bst = rlc.RlcStats()
    assert rlc.host_rlc_check(bops, bcands, stats=bst)
    assert bst.miller_lanes == 3 and bst.final_exp_lanes == 1
    bad = [bcands[0], (b"bls-b", bkeys[1][1].point, bkeys[1][0].sign(b"x").point)]
    assert not rlc.host_rlc_check(bops, bad)
    print("rlc_smoke: bls12-381 host ops seam: valid accepted, forged rejected")

    t_host = time.perf_counter() - t0
    # -- the engine's dispatch seam: both packing classes route into rlc ---
    from handel_tpu_torch.models.bn254 import BN254PublicKey, BN254Signature
    from handel_tpu_torch.models.bn254_torch import BN254Device
    from handel_tpu_torch.ops import bn254_ref as bn

    n_dev = 130  # > MISS_CAP, so that the dense class is reachable
    sks = [rng.randrange(1, 1 << 20) for _ in range(n_dev)]
    dpks = [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks]
    device = BN254Device(dpks, batch_size=4, batch_check="rlc", device=dev_type)
    range_bs = BitSet(n_dev)
    for i in range(8):
        range_bs.set(i)
    dense_bs = BitSet(n_dev)
    dense_bs.set(0)
    dense_bs.set(n_dev - 1)  # the whole hull, > 64 holes: the dense class
    for i in rng.sample(range(n_dev), 40):
        dense_bs.set(i)
    for bs, kind in ((range_bs, "range"), (dense_bs, "dense")):
        plan = device._pack_requests([(bs, BN254Signature(bn.G1_GEN))])
        assert plan.kind == kind, (kind, plan.kind)
        handle = device.dispatch(b"m", [(bs, BN254Signature(bn.G1_GEN))])
        assert handle[0] == "rlc", handle[0]
    print("rlc_smoke: rlc-mode device routes range + dense packing classes")
    print(f"rlc_smoke: OK ({t_host:.1f} s on the host checks, "
          f"{time.perf_counter() - t0 - t_host:.1f} s on the engine)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
