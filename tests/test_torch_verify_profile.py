"""The port's stage profile of the verify launch
(handel_tpu_torch/scripts/verify_profile.py) and its candidate batch
(scripts/launch_problem.py) against the JAX package, on the CPU.

- `build_problem` draws the same batch as bench.py's from the same seed:
  the same ranges, holes, validity and points, bit for bit.
- The aggregation stage gives each candidate's aggregate key: the JAX
  package's host oracle here, and the JAX engine's `_range_agg_kernel`
  after `to_affine` in the slow tier (its XLA compile takes about 100 s on
  one core).
- The stages, composed, give the full launch's verdicts on both field
  backends (16 keys, 4 lanes, lanes 1 and 2 forged and rejected).
- `main` writes a record with every stage key; a CPU run without `--out`
  and a card asked for where there is none are refused.
Tolerance: bitwise everywhere.
"""

import json

import jax
import numpy as np
import pytest
import torch

import bench
from handel_tpu.models.bn254 import BN254PublicKey as JPublicKey
from handel_tpu.models.bn254_jax import BN254Device as JaxDevice
from handel_tpu.ops import bn254_ref as jbn
from handel_tpu.ops.curve import BN254Curves as JCurves
from handel_tpu_torch.models.bn254 import BN254PublicKey, BN254Signature
from handel_tpu_torch.models.bn254_torch import BN254Device
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.scripts import verify_profile
from handel_tpu_torch.scripts.launch_problem import build_problem, measure_pipelined

torch.set_num_threads(1)

N, C = 16, 4


def pure_g1(pts, ks):
    return [jbn.g1_mul(p, k) for p, k in zip(pts, ks)]


def pure_g2(pts, ks):
    return [jbn.g2_mul(p, k) for p, k in zip(pts, ks)]


def test_build_problem_matches_bench():
    """The same seed gives bench.py's lo, hi, holes, validity, keys, H and
    signatures, and requests whose bitsets are the ranges less the holes."""
    n, lanes, cands = 64, 8, 6
    curves = JCurves()
    pks, miss_k, args = bench.build_problem(
        curves, n, lanes, cands, ref=jbn, g1_mul_batch=pure_g1, g2_mul_batch=pure_g2
    )
    lo, hi, miss_idx, miss_ok, sig_x, sig_y, h_x, h_y, valid = args
    prob = build_problem(n, lanes, cands)
    assert prob.miss_k == miss_k
    for mine, theirs in ((prob.lo, lo), (prob.hi, hi), (prob.miss_idx, miss_idx),
                         (prob.miss_ok, miss_ok), (prob.valid, valid)):
        # jax keeps 32-bit integers: the values, not the dtypes, must agree
        assert np.array_equal(mine, np.asarray(theirs))
    assert prob.pks == pks
    F = curves.F
    assert [prob.h[0], prob.h[1]] == F.unpack(h_x) + F.unpack(h_y)
    assert [p[0] for p in prob.sig_pts] == F.unpack(sig_x)
    assert [p[1] for p in prob.sig_pts] == F.unpack(sig_y)
    holes = prob.miss_idx.reshape(miss_k, lanes)
    ok = prob.miss_ok.reshape(miss_k, lanes)
    for j, (bs, sig) in enumerate(prob.requests):
        gone = set(holes[ok[:, j], j].tolist())
        assert list(bs.indices()) == [i for i in range(lo[j], hi[j]) if i not in gone]
        assert sig.point == prob.sig_pts[j]
    assert len(prob.requests) == cands


def forged_problem():
    """build_problem's 16-key, 4-lane batch with lane 1's signature off by
    one scalar and lane 2 signed on another point: (problem, expected
    verdicts)."""
    prob = build_problem(N, C, C, seed=16)
    for j, point in ((1, bn.g1_add(prob.sig_pts[1], prob.h)),
                     (2, bn.g1_mul(bn.G1_GEN, 7))):
        prob.requests[j] = (prob.requests[j][0], BN254Signature(point))
    return prob, [True, False, False, True]


def engine_for(prob, fp_backend):
    eng = BN254Device([BN254PublicKey(p) for p in prob.pks], batch_size=C,
                      device="cpu", fp_backend=fp_backend)
    F = eng.curves.F
    return eng, (F.pack([prob.h[0]]), F.pack([prob.h[1]]))


def stage_aggregates(prob):
    eng, h = engine_for(prob, "cios")
    stages = verify_profile.LaunchStages(eng, prob.requests, h)
    x, y, inf = eng.curves.g2.to_affine(stages.range_agg())
    xs, ys = eng.curves.T.f2_unpack(x), eng.curves.T.f2_unpack(y)
    return stages, [None if inf[j] else (xs[j], ys[j]) for j in range(C)]


def test_aggregation_stage_matches_host_oracle():
    prob, _ = forged_problem()
    _, got = stage_aggregates(prob)
    for j, (bs, _sig) in enumerate(prob.requests):
        want = None
        for i in bs.indices():
            want = prob.pks[i] if want is None else jbn.g2_add(want, prob.pks[i])
        assert got[j] == want, j


@pytest.mark.slow
def test_aggregation_stage_matches_jax_range_agg_kernel():
    """The JAX engine's `_range_agg_kernel` over its own packing of the same
    requests, after to_affine (slow: an XLA compile of about 100 s)."""
    prob, _ = forged_problem()
    stages, got = stage_aggregates(prob)
    jdev = JaxDevice([JPublicKey(p) for p in prob.pks], batch_size=C)
    plan = jdev._pack_requests(prob.requests)
    assert plan.miss_k == stages.miss_k
    agg = jdev._range_agg_kernel(plan.miss_k)(*jdev._stage_plan(plan)[:4])
    x, y, inf = jdev.curves.g2.to_affine(agg)
    jax.block_until_ready(x)
    xs, ys = jdev.curves.T.f2_unpack(x), jdev.curves.T.f2_unpack(y)
    infs = np.asarray(inf)
    assert got == [None if infs[j] else (xs[j], ys[j]) for j in range(C)]


@pytest.mark.parametrize("fp_backend", ["cios", "rns"])
def test_composed_stages_give_the_full_launch_verdicts(fp_backend):
    prob, expect = forged_problem()
    eng, h = engine_for(prob, fp_backend)
    stages = verify_profile.LaunchStages(eng, prob.requests, h)
    lanes = stages.affine(stages.range_agg())
    composed = stages.final_exp(stages.miller_loop_2c(lanes), lanes).tolist()
    assert composed == stages.full_launch().tolist() == expect


def test_measure_pipelined_waits_on_the_last_launch_only():
    calls, blocked = [], []
    launch = lambda: calls.append(len(calls)) or len(calls)  # noqa: E731
    ts = measure_pipelined(launch, blocked.append, trials=2, depth=3)
    assert len(ts) == 2 and all(t >= 0 for t in ts)
    assert len(calls) == 9 and blocked == [3, 6, 9]
    calls.clear()
    blocked.clear()
    measure_pipelined(launch, blocked.append, trials=2, depth=3, warm=False)
    assert len(calls) == 6 and blocked == [3, 6]


def test_main_writes_every_stage_key(tmp_path):
    out = tmp_path / "vp.json"
    out.write_text('{"cios": {"kept": true}}')
    rc = verify_profile.main(["--device", "cpu", "--trials", "1", "--out", str(out),
                              "--fp-backend", "rns", "--depth", "1",
                              "--registry", str(N), "--lanes", str(C),
                              "--candidates", "3"])
    assert rc == 0
    records = json.loads(out.read_text())
    assert records["cios"] == {"kept": True}
    rec = records["rns"]
    for key in ("dispatch_rt_ms", "range_agg_ms", "affine_ms", "miller_loop_2c_ms",
                "final_exp_ms", "full_launch_ms", "stage_sum_ms",
                "pipelined_per_launch_ms"):
        assert rec[key] > 0, key
    assert set(rec["launches"]) == {*verify_profile.STAGES, "full_launch"}
    assert rec["launch_sum"]["difference"] == {"fp_mont_mul": 0, "rns_mont_mul_resident": 0}
    assert rec["verdicts_ok"] and rec["verdicts_equal"]
    assert rec["kernel"] == "rns_mont_mul_resident" and rec["fp_backend"] == "rns"
    assert rec["nvidia_smi"] is None and rec["device"] == "cpu"
    assert (rec["registry"], rec["lanes"], rec["candidates"], rec["trials"]) == (N, C, 3, 1)


def test_main_refuses_a_cpu_run_without_out_and_a_missing_card(tmp_path):
    with pytest.raises(SystemExit) as e:
        verify_profile.main(["--device", "cpu"])
    assert e.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            verify_profile.main(["--out", str(tmp_path / "x.json")])
