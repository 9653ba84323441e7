"""Stage profile of the flagship verify launch — counterpart of
scripts/verify_profile.py.

    python -m handel_tpu_torch.scripts.verify_profile [--trials N]
        [--fp-backend cios|rns] [--device cuda|cpu] [--out PATH]

Builds the reference's launch (launch_problem.py `build_problem`: a
4096-key registry, 128 lanes, 64 range candidates, seed 2024) on one
`BN254Device`, packs the candidates with the engine's own packer, and times
one range launch cut at its stage boundaries:

  dispatch_rt      `x + 1` on a device-resident (8, 128) int32 tensor, then a
                   16-word fetch to the host: the floor every launch pays
  range_agg        `BN254Device._range_aggregate`: prefix gather and hole
                   patch, projective
  affine           the pairing tail's affine step (`_pairing_lanes`): the
                   aggregates to affine and the 2C pair lanes
  miller_loop_2c   the Miller loop over the 2C lanes (H beside each
                   aggregate, -S beside the G2 generator), in the working
                   representation: residues on rns, as in the launch
  final_exp        the per-candidate product of the pair lanes, the shared
                   final exponentiation at C lanes and the comparison with 1
                   (`BN254Pairing.check_product`; resident on rns)
  full_launch      `_verify_batch_range` whole
  pipelined        `measure_pipelined` at depth 8: per-launch ms of full
                   launches issued back to back

The stages are the launch's own methods, called one after another, so
composed they compute what the launch computes, with no conversion or copy
the launch lacks: their verdicts must equal the full launch's, and their
kernel launches (B1, `fp_mont_mul`, on cios; B2, `rns_mont_mul_resident`,
on rns) must add up to the full launch's. The reference's profile runs its
final exponentiation at 2C lanes; the launch, and so this stage, runs it at
C, after the product.

Each stage is a p50 of `--trials` calls after one warm call, each call
ending in `torch.cuda.synchronize()` on the card. The record keeps each
stage's ms and kernel launches, the stage sum against the full launch, the
card's name and power limit (nvidia-smi) and the shape, under its
backend's key in a JSON file that keeps the other backend's record; by
default results/torch/verify_profile.json (the JAX package's
results/verify_profile.json is a TPU's, and none of its figures is the
port's). A CPU run must name `--out`: no CPU figure goes to the default
file. `--registry`, `--lanes` and `--candidates` cut the shape for a run on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

from handel_tpu_torch.kernels.fp_mont import mont_mul
from handel_tpu_torch.kernels.rns_mont import rns_mul_resident
from handel_tpu_torch.models.bn254 import BN254PublicKey
from handel_tpu_torch.models.bn254_torch import BN254Device
from handel_tpu_torch.ops.fp import device_name
from handel_tpu_torch.scripts.artifacts import card_line, write_json_atomic
from handel_tpu_torch.scripts.launch_problem import (
    PIPELINE_DEPTH,
    build_problem,
    measure_pipelined,
)
from handel_tpu_torch.utils.torchenv import resolve_device

N_REGISTRY, LANES, CANDIDATES = 4096, 128, 64
DEFAULT_OUT = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "results", "torch",
    "verify_profile.json"))
# the stages in launch order, then the whole launch
STAGES = ("range_agg", "affine", "miller_loop_2c", "final_exp")
# each backend's kernel: B1 carries the cios field, B2 the rns one
KERNELS = {"cios": "fp_mont_mul", "rns": "rns_mont_mul_resident"}
COUNTERS = {"fp_mont_mul": mont_mul, "rns_mont_mul_resident": rns_mul_resident}


class LaunchStages:
    """One range launch of `engine` over `requests`, packed and staged by
    the engine's own `_pack_requests` and `_stage_plan`, cut at its stage
    boundaries. `h` is the (x, y) limb columns of the point every lane
    signed. Every stage runs on the engine's verify stream, as a dispatch
    does."""

    def __init__(self, engine: BN254Device, requests, h):
        plan = engine._pack_requests(requests)
        if plan.kind != "range":
            raise ValueError(f"the requests pack as a {plan.kind} launch, not a range one")
        self.engine = engine
        self.miss_k = plan.miss_k
        self.staged = engine._issue(engine._stage_plan, plan)
        self.h_x, self.h_y = h
        # the prefix table is built at its first read: here, outside every stage
        engine._issue(lambda: engine._prefix)
        sync(engine.device)  # the pinned staging set is free for the next pack

    def range_agg(self):
        e = self.engine
        lo, hi, miss_idx, miss_ok = self.staged[:4]
        return e._issue(e._range_aggregate, lo, hi, miss_idx, miss_ok, e._prefix,
                        e.bank.reg_x, e.bank.reg_y, self.miss_k)

    def affine(self, agg):
        e = self.engine
        sig_x, sig_y, valid = self.staged[4:]
        return e._issue(e._pairing_lanes, agg, sig_x, sig_y, self.h_x, self.h_y, valid)

    def miller_loop_2c(self, lanes):
        e = self.engine
        p, q, lane_mask, _ok = lanes
        return e._issue(e.pairing._miller_loop_res, p, q, lane_mask)

    def final_exp(self, f, lanes):
        e = self.engine
        return e._issue(lambda: e.pairing.check_product(f, e.batch_size) & lanes[3])

    def full_launch(self):
        e = self.engine
        lo, hi, miss_idx, miss_ok, sig_x, sig_y, valid = self.staged
        return e._issue(e._verify_batch_range, lo, hi, miss_idx, miss_ok, sig_x, sig_y,
                        self.h_x, self.h_y, valid, e._prefix, e.bank.reg_x, e.bank.reg_y,
                        self.miss_k)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device, trials: int, warm: bool = True):
    """(p50 ms of `trials` calls of fn after one warm call unless `warm` is
    False, {kernel: launches in the first call}, the first call's result).
    Each call ends in a synchronize on the card."""
    times, launches, first = [], None, None
    for i in range(trials + (1 if warm else 0)):
        before = {k: c.launches for k, c in COUNTERS.items()}
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        dt = (time.perf_counter() - t0) * 1e3
        if launches is None:
            launches = {k: c.launches - before[k] for k, c in COUNTERS.items()}
            first = out
        if i or not warm:
            times.append(dt)
    return statistics.median(times), launches, first


def profile(engine: BN254Device, requests, h, trials: int, depth: int = PIPELINE_DEPTH,
            pipelined_trials: int | None = None, warm: bool = True):
    """Times each stage of `engine`'s range launch over `requests` (see the
    module docstring) and composes them. Returns (record, composed verdicts,
    full-launch verdicts), the verdicts as lists of bool over every lane.
    `warm=False` drops the warm calls, for an engine whose launches have run
    before; `pipelined_trials` defaults to `trials`."""
    dev = engine.device
    stages = LaunchStages(engine, requests, h)
    out: dict = {}
    launches: dict = {}

    x = torch.ones((8, 128), dtype=torch.int32, device=dev)
    out["dispatch_rt_ms"], _, _ = timed(lambda: (x + 1).reshape(-1)[:16].cpu(), dev,
                                        trials, warm)
    out["range_agg_ms"], launches["range_agg"], agg = timed(stages.range_agg, dev,
                                                            trials, warm)
    out["affine_ms"], launches["affine"], lanes = timed(lambda: stages.affine(agg), dev,
                                                        trials, warm)
    out["miller_loop_2c_ms"], launches["miller_loop_2c"], f = timed(
        lambda: stages.miller_loop_2c(lanes), dev, trials, warm)
    out["final_exp_ms"], launches["final_exp"], verdicts = timed(
        lambda: stages.final_exp(f, lanes), dev, trials, warm)
    out["full_launch_ms"], launches["full_launch"], full = timed(stages.full_launch, dev,
                                                                 trials, warm)
    out["stage_sum_ms"] = sum(out[f"{s}_ms"] for s in STAGES)
    out["stage_sum_over_full_launch"] = out["stage_sum_ms"] / out["full_launch_ms"]
    ts = measure_pipelined(stages.full_launch, lambda _r: sync(dev),
                           trials if pipelined_trials is None else pipelined_trials,
                           depth=depth, warm=warm)
    out["pipelined_depth"] = depth
    out["pipelined_per_launch_ms"] = statistics.median(ts)
    out["pipelined_over_full_launch"] = out["pipelined_per_launch_ms"] / out["full_launch_ms"]

    kernel = KERNELS[engine.curves.F.backend]
    summed = {k: sum(launches[s][k] for s in STAGES) for k in COUNTERS}
    diff = {k: summed[k] - launches["full_launch"][k] for k in COUNTERS}
    out["kernel"] = kernel
    out["launches"] = launches
    out["launch_sum"] = {"stages": summed, "full_launch": launches["full_launch"],
                         "difference": diff}
    if any(diff.values()):
        out["launch_sum"]["why"] = (
            "the stages are the launch's own methods in its order, so a difference "
            "means a stage ran work the launch does not (or the reverse)")
    composed = [bool(v) for v in verdicts.tolist()]
    full = [bool(v) for v in full.tolist()]
    out["verdicts_equal"] = composed == full
    return out, composed, full


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m handel_tpu_torch.scripts.verify_profile",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=9)
    ap.add_argument("--fp-backend", choices=("cios", "rns"), default="cios")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help=f"the record's path (default {os.path.relpath(DEFAULT_OUT)}; "
                         "a CPU run must name one)")
    ap.add_argument("--depth", type=int, default=PIPELINE_DEPTH,
                    help="launches a pipelined round")
    ap.add_argument("--registry", type=int, default=N_REGISTRY)
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--candidates", type=int, default=CANDIDATES)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda" and args.out is None:
        ap.error("a run off the card must name --out: no CPU figure goes to "
                 f"{os.path.relpath(DEFAULT_OUT)}")

    t0 = time.perf_counter()
    prob = build_problem(args.registry, args.lanes, args.candidates)
    engine = BN254Device([BN254PublicKey(p) for p in prob.pks], batch_size=args.lanes,
                         device=dev, fp_backend=args.fp_backend)
    F = engine.curves.F
    h = (F.pack([prob.h[0]]), F.pack([prob.h[1]]))
    sync(dev)
    setup_s = time.perf_counter() - t0
    out, composed, full = profile(engine, prob.requests, h, args.trials, depth=args.depth)
    expect = [True] * args.candidates + [False] * (args.lanes - args.candidates)
    out["verdicts_ok"] = composed == expect and full == expect
    out.update({
        "fp_backend": args.fp_backend, "device": device_name(dev),
        "nvidia_smi": card_line(dev), "trials": args.trials, "registry": args.registry,
        "lanes": args.lanes, "candidates": args.candidates, "setup_s": setup_s,
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    })
    print(json.dumps(out, indent=1))
    path = args.out or DEFAULT_OUT
    records = {}
    if os.path.exists(path):
        try:  # a file cut short by a killed writer holds nothing to keep
            with open(path) as f:
                records = json.load(f)
        except (OSError, ValueError):
            records = {}
    records[args.fp_backend] = out
    write_json_atomic(path, records)
    print(f"verify_profile: wrote the {args.fp_backend} record to {path}")
    if not (out["verdicts_ok"] and out["verdicts_equal"]):
        print("verify_profile: the verdicts are wrong")
        return 1
    if any(out["launch_sum"]["difference"].values()):
        print(f"verify_profile: the stages' launches differ from the full launch's: "
              f"{out['launch_sum']}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
