"""Count the kernel-launching torch ops of one verify launch, on the CPU.

    python -m handel_tpu_torch.utils.opcount [--registry 64] [--lanes 4] [--combine-lanes 128]
        [--rlc-lanes 128]
    python -m handel_tpu_torch.utils.opcount --curve bls12-381 [--registry 64] [--lanes 4]
        [--combine-lanes 64] [--dense-registry 1024]

Runs one range launch per field backend ("cios", then "rns") through
`BN254TorchScheme(device="cpu")` under a `TorchDispatchMode` that counts
every dispatched op except views (which launch nothing on a card), with
each kernel wrapper's plain version counted as one op, as the card runs it
as one kernel. The per-candidate count does not depend on the batch width,
so it predicts a card's device-activity count per launch at any width; it
is a count, not a device measurement. An RLC launch's count does: its MSMs'
masked sums over the C candidate blocks take ceil(log2 C) tree stages a
window, so it is counted at the card's width, `--rlc-lanes`. `scopes`
attributes the ops issued inside the per-mul `RnsField.mul`, inside
`Field.inv` (the affine conversion's Fermat inverse), inside `Curve.msm`
and inside the RLC pairing tail (`BN254Device._rlc_check`) on top of the
total. Prints one JSON line per
backend, then one per backend for a `combine_batch` chunk at
`--combine-lanes` lanes computed on that backend's field, then one per
backend for an honest RLC range launch of `--rlc-lanes` candidates
(`batch_check="rlc"`, one message).

`--curve bls12-381` counts the BLS12-381 launch classes on
`BLS12381TorchScheme(device="cpu")` instead: a range launch per backend
over `--registry` keys, a dense launch on cios over `--dense-registry`
keys (random quarter subsets; its masked sum takes log2 of the registry
tree stages, so the default is the registry chip_smoke.py's phase 11 runs
it at), and a cios `combine_batch` chunk. The RLC launch is not counted
for this curve. Each line names its curve. The curve's family (oracle,
key types, hash) is the device scheme's engine class, found by the
scheme's name `<curve>-cuda` in models/registry.py.
"""

from __future__ import annotations

import argparse
import collections
import json
import random

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

# ops that only make views: no kernel on the card
VIEW_OPS = frozenset({
    "aten.slice", "aten.unsqueeze", "aten.select", "aten.expand", "aten.view",
    "aten._unsafe_view", "aten.reshape", "aten.t", "aten.transpose", "aten.alias",
    "aten.as_strided", "aten.detach", "aten.split", "aten.squeeze", "aten.permute",
    "aten.unbind", "aten.split_with_sizes", "aten.lift_fresh", "aten._reshape_alias",
})


class OpCounter(TorchDispatchMode):
    """Counts dispatched ops by name, and the kernel-launching ones issued
    inside each open scope by scope name."""

    def __init__(self):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()
        self.scopes: collections.Counter = collections.Counter()
        self.open: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.counts[name] += 1
        if name not in VIEW_OPS:
            for scope in set(self.open):
                self.scopes[scope] += 1
        return func(*args, **(kwargs or {}))

    def launches(self) -> int:
        return sum(v for k, v in self.counts.items() if k not in VIEW_OPS)


def _counted(run):
    """Run `run()` under an OpCounter, each kernel wrapper's plain version
    counted as one op (the card runs it as one kernel, `kernel` in the
    counts), with the per-mul `RnsField.mul` and `Field.inv` scoped.
    Returns (counter, result)."""
    from handel_tpu_torch.models.bn254_torch import BN254Device
    from handel_tpu_torch.ops.curve import Curve
    from handel_tpu_torch.ops.fp import Field
    from handel_tpu_torch.ops.rns import RnsField

    counter = OpCounter()
    plain = {(Field, "_mul_plain"), (RnsField, "_mul_resident_core")}
    scoped = {(RnsField, "mul"): "rns_per_mul", (Field, "inv"): "field_inv",
              (Curve, "msm"): "msm", (BN254Device, "_rlc_check"): "rlc_pairing_tail"}
    saved = {key: getattr(*key) for key in [*plain, *scoped]}

    def as_one_kernel(fn):
        def wrapped(self, a, b):
            with _disable_current_modes():
                out = fn(self, a, b)
            counter.counts["kernel"] += 1
            for scope in set(counter.open):
                counter.scopes[scope] += 1
            return out
        return wrapped

    def in_scope(fn, scope):
        def wrapped(*args, **kw):
            counter.open.append(scope)
            try:
                return fn(*args, **kw)
            finally:
                counter.open.pop()
        return wrapped

    try:
        for key in plain:
            setattr(*key, as_one_kernel(saved[key]))
        for key, scope in scoped.items():
            setattr(*key, in_scope(saved[key], scope))
        with counter:
            result = run()
    finally:
        for key, fn in saved.items():
            setattr(*key, fn)
    return counter, result


def _constructor(curve: str, lanes: int, backend: str = "cios", **kw):
    """The CPU constructor of the curve's device scheme, `<curve>-cuda`."""
    from handel_tpu_torch.models.registry import new_scheme

    return new_scheme(f"{curve}-cuda", batch_size=lanes, device="cpu", fp_backend=backend,
                      warmup=False, **kw).constructor


def _range_problem(family, registry: int, lanes: int, seed: int, dense: bool = False):
    """Seeded registry keys, message and `lanes` honest candidates of the
    engine class `family`'s curve: range candidates of registry/4
    contiguous signers each, or with `dense` random quarter subsets."""
    from handel_tpu_torch.core.bitset import BitSet

    ref = family.ref
    rng = random.Random(seed)
    sks = [rng.randrange(1, 1 << 30) for _ in range(registry)]
    pks = [family.PublicKey(ref.g2_mul(ref.G2_GEN, s)) for s in sks]
    msg = b"op count"
    h = family._hash_to_g1(msg)
    requests = []
    for _ in range(lanes):
        if dense:
            idx = rng.sample(range(registry), registry // 4)
        else:
            lo = rng.randrange(0, registry // 2)
            idx = range(lo, lo + registry // 4)
        bs = BitSet(registry)
        for i in idx:
            bs.set(i, True)
        requests.append((bs, family.Signature(ref.g1_mul(h, sum(sks[i] for i in idx) % ref.R))))
    return pks, msg, requests


def _top(counter) -> dict:
    top = sorted(
        ((k, v) for k, v in counter.counts.items() if k not in VIEW_OPS), key=lambda kv: -kv[1]
    )[:10]
    return dict(top)


def count_range_launch(backend: str, registry: int, lanes: int, seed: int = 1,
                       curve: str = "bn254", dense: bool = False) -> dict:
    """The kernel-launching ops of one honest launch of the range class (or
    with `dense` the dense class) on the curve's device scheme."""
    cons = _constructor(curve, lanes, backend)
    pks, msg, requests = _range_problem(cons.Device, registry, lanes, seed, dense)
    eng = cons.prepare(pks)
    kind = "dense" if dense else "range"
    if eng._pack_requests(requests).kind != kind:
        raise AssertionError(f"{curve} {kind} candidates packed as another launch class")
    _ = eng._prefix  # built at the first range launch: not part of a launch
    counter, verdicts = _counted(lambda: cons.batch_verify(msg, pks, requests))
    if not all(verdicts):
        raise AssertionError(f"{backend}: a valid candidate was rejected")
    return {"curve": curve, "backend": backend, "launch_class": kind, "lanes": lanes,
            "registry": registry, "kernel_launching_ops": counter.launches(),
            "kernel_calls": counter.counts["kernel"], "scopes": dict(counter.scopes),
            "top": _top(counter)}


def count_rlc_launch(backend: str, registry: int, lanes: int, seed: int = 1) -> dict:
    """The kernel-launching ops of one honest RLC range launch of `lanes`
    candidates on one message: a combined check that passes, no bisection
    (the prefix table is built before the count)."""
    from handel_tpu_torch.models.bn254_torch import BN254Device

    pks, msg, requests = _range_problem(BN254Device, registry, lanes, seed)
    eng = BN254Device(pks, batch_size=lanes, device="cpu", fp_backend=backend,
                      batch_check="rlc", rlc_rng=random.Random(seed))
    _ = eng._prefix
    counter, verdicts = _counted(lambda: eng.fetch(eng.dispatch(msg, requests)))
    if not all(verdicts) or eng.rlc_stats.bisection_ct:
        raise AssertionError(f"{backend}: the honest RLC launch failed its combined check")
    return {"curve": "bn254", "backend": backend, "launch_class": "rlc range", "lanes": lanes,
            "registry": registry, "kernel_launching_ops": counter.launches(),
            "kernel_calls": counter.counts["kernel"], "scopes": dict(counter.scopes),
            "top": _top(counter)}


def count_combine(backend: str, lanes: int, k: int = 4, seed: int = 1,
                  curve: str = "bn254") -> dict:
    """The kernel-launching ops of one `combine_batch` chunk (one group of k
    points, class k, after a warm call) computed on the given backend's
    field. The engine itself combines on the cios field whatever its
    backend; this count is why (models/bn254_torch.py)."""
    Device = _constructor(curve, lanes).Device
    ref = Device.ref
    rng = random.Random(seed)
    pts = [ref.g1_mul(ref.G1_GEN, rng.randrange(1, ref.R)) for _ in range(k)]
    pks, _, _ = _range_problem(Device, 4, 0, seed)
    eng = Device(pks, batch_size=lanes, device="cpu")
    eng._combine_curves = Device.Curves(device="cpu", backend=backend)
    eng.combine_batch([pts])
    counter, _ = _counted(lambda: eng.combine_batch([pts]))
    return {"curve": curve, "backend": backend, "launch_class": f"combine k={k}",
            "lanes": lanes, "kernel_launching_ops": counter.launches(),
            "kernel_calls": counter.counts["kernel"], "scopes": dict(counter.scopes)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--registry", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--combine-lanes", type=int, default=128)
    ap.add_argument("--rlc-lanes", type=int, default=128)
    ap.add_argument("--curve", choices=("bn254", "bls12-381"), default="bn254")
    ap.add_argument("--dense-registry", type=int, default=1024,
                    help="registry of the BLS12-381 dense count (phase 11's); quarter "
                         "subsets pack as dense only when their hulls hold more holes "
                         "than the engine's MISS_CAP")
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.curve == "bls12-381":
        for backend in ("cios", "rns"):
            print(json.dumps(count_range_launch(backend, args.registry, args.lanes,
                                                curve=args.curve)), flush=True)
        print(json.dumps(count_range_launch("cios", args.dense_registry, args.lanes,
                                            curve=args.curve, dense=True)), flush=True)
        print(json.dumps(count_combine("cios", args.combine_lanes, curve=args.curve)),
              flush=True)
        return
    for backend in ("cios", "rns"):
        print(json.dumps(count_range_launch(backend, args.registry, args.lanes)), flush=True)
    for backend in ("cios", "rns"):
        print(json.dumps(count_combine(backend, args.combine_lanes)), flush=True)
    for backend in ("cios", "rns"):
        print(json.dumps(count_rlc_launch(backend, args.registry, args.rlc_lanes)), flush=True)


if __name__ == "__main__":
    main()
