"""The flagship verify launch's candidate batch and the pipelined timing
method — counterparts of bench.py `build_problem` and `measure_pipelined`.

`build_problem` draws the reference's Handel-realistic batch from the same
seed in the same order: a registry of keys from small scalars, one G1 point
H, and `n_candidates` contiguous partitioner ranges of n/8, n/4 or n/2 keys,
each with up to `miss_k` - 1 offline holes, signed by the signers' summed
scalar. It returns the reference's launch arrays (for parity with the JAX
package) and the same candidates as `(BitSet, Signature)` requests, which a
caller hands to the engine's own packer (`BN254Device._pack_requests`, then
`_stage_plan`), so the launch sees exactly what a dispatch would stage.

`measure_pipelined` is the one copy of the pipelined method in the port:
`depth` launches issued back to back, waiting only on the last.
`scripts/verify_profile.py` uses both; the port's benchmark is to use them
too.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

import numpy as np

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.models.bn254 import BN254Signature
from handel_tpu_torch.ops import bn254_ref

SEED = 2024
PIPELINE_DEPTH = 8


@dataclass
class LaunchProblem:
    """One launch's candidates. `pks` are the registry's G2 keys (affine
    oracle tuples) from the scalars `sks`; `h` is the G1 point every
    candidate signed. `lo`, `hi` (lanes,) int32 are each lane's range,
    `miss_idx` (miss_k * lanes,) int64 and `miss_ok` its holes, block-major
    (row i = hole i of every lane), `sig_pts` (lanes,) the aggregate
    signatures (padded lanes carry G1_GEN) and `valid` (lanes,) the real
    lanes: bench.py's arrays before they are packed into limbs. `requests`
    holds the n_candidates candidates as (BitSet, Signature)."""

    sks: list
    pks: list
    h: tuple
    miss_k: int
    lo: np.ndarray
    hi: np.ndarray
    miss_idx: np.ndarray
    miss_ok: np.ndarray
    sig_pts: list
    valid: np.ndarray
    requests: list


def build_problem(
    n_registry: int,
    lanes: int,
    n_candidates: int,
    ref=bn254_ref,
    g1_mul_batch=None,
    g2_mul_batch=None,
    signature=BN254Signature,
    miss_k: int = 8,
    seed: int = SEED,
) -> LaunchProblem:
    """The reference's candidate batch (bench.py `build_problem`), drawn
    from `random.Random(seed)` in its order. `ref` is the curve's scalar
    oracle (G1_GEN, G2_GEN, R) and the `*_mul_batch(points, scalars)` hooks
    do the keygen; by default they are `ref`'s own pure-Python
    multiplications. `signature` wraps a G1 point into the request's
    signature."""
    if g1_mul_batch is None:
        g1_mul_batch = lambda pts, ks: [ref.g1_mul(p, k) for p, k in zip(pts, ks)]  # noqa: E731
    if g2_mul_batch is None:
        g2_mul_batch = lambda pts, ks: [ref.g2_mul(p, k) for p, k in zip(pts, ks)]  # noqa: E731
    if n_candidates > lanes:
        raise ValueError(f"{n_candidates} candidates do not fit {lanes} lanes")
    rng = random.Random(seed)
    # small scalars keep the host keygen fast; the device's cost does not
    # depend on the scalars' size
    sks = [rng.randrange(1, 1 << 30) for _ in range(n_registry)]
    pks = g2_mul_batch([ref.G2_GEN] * n_registry, sks)
    h = g1_mul_batch([ref.G1_GEN], [rng.randrange(1, ref.R)])[0]

    lo = np.zeros((lanes,), np.int32)
    hi = np.zeros((lanes,), np.int32)
    miss_idx = np.zeros((miss_k, lanes), np.int64)
    miss_ok = np.zeros((miss_k, lanes), dtype=bool)
    agg_sks, signer_sets = [], []
    for j in range(n_candidates):
        size = rng.choice([n_registry // 8, n_registry // 4, n_registry // 2])
        lo[j] = rng.randrange(0, n_registry - size)
        hi[j] = lo[j] + size
        max_holes = min(miss_k, size - 1)  # at least one signer stays
        holes = sorted(
            rng.sample(
                range(int(lo[j]), int(hi[j])),
                rng.randrange(0, max_holes) if max_holes > 0 else 0,
            )
        )
        miss_idx[: len(holes), j] = holes
        miss_ok[: len(holes), j] = True
        signers = sorted(set(range(int(lo[j]), int(hi[j]))) - set(holes))
        signer_sets.append(signers)
        agg_sks.append(sum(sks[i] for i in signers) % ref.R)
    sig_pts = g1_mul_batch([h] * n_candidates, agg_sks)
    requests = []
    for signers, pt in zip(signer_sets, sig_pts):
        bs = BitSet(n_registry)
        for i in signers:
            bs.set(i, True)
        requests.append((bs, signature(pt)))
    sig_pts = list(sig_pts) + [ref.G1_GEN] * (lanes - n_candidates)
    valid = np.zeros((lanes,), dtype=bool)
    valid[:n_candidates] = True
    return LaunchProblem(
        sks=sks, pks=pks, h=h, miss_k=miss_k, lo=lo, hi=hi,
        miss_idx=miss_idx.reshape(-1), miss_ok=miss_ok.reshape(-1),
        sig_pts=sig_pts, valid=valid, requests=requests,
    )


def measure_pipelined(launch, block, trials: int, depth: int = PIPELINE_DEPTH,
                      warm: bool = True) -> list[float]:
    """Per-launch ms of `depth` launches issued back to back, waiting only
    on the last (`block(result)`; a stream runs its launches in order, so
    the last done means all are), once per trial. One warm round of `depth`
    launches comes first unless `warm` is False (a caller whose launches
    have all run before). Returns the `trials` per-launch times."""
    if warm:
        rs = [launch() for _ in range(depth)]
        block(rs[-1])
    out = []
    for _ in range(trials):
        t0 = time.perf_counter()
        rs = [launch() for _ in range(depth)]
        block(rs[-1])
        out.append((time.perf_counter() - t0) * 1000.0 / depth)
    return out
