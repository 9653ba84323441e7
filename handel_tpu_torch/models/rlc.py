"""Random-linear-combination (RLC) batch verification: scalars, the
bisection driver, and the host-math combined check — a copy of
handel_tpu/models/rlc.py.

The small-exponents batch test (Bellare–Garay–Rabin): instead of one
pairing check e(H(m_j), X_j) == e(S_j, B2) per candidate j, draw random
64-bit coefficients r_j (r_0 = 1) and check the single equation

    e(-S, B2) * prod_m e(H(m), X_m) == 1,
    S   = sum_j r_j * S_j           (G1 MSM over the signatures)
    X_m = sum_{j: msg_j = m} r_j * X_j   (G2 MSM per message group)

A forged batch passes only if the forgeries cancel under the random
combination — probability <= 2^-64 per attempt, and the coefficients are
drawn fresh per launch from a CSPRNG so an adversary cannot precompute
them. Honest-case cost per launch drops from 2C Miller loops + C final
exponentiations to M+1 Miller loops + 1 final exponentiation (M = number
of distinct messages) plus the two MSMs, which are plain group ops.

When the combined check fails, `bisect_verify` splits the batch and
rechecks each half with FRESH scalars (reusing scalars would let a
crafted pair of forgeries keep cancelling), recursing down to the
per-candidate oracle for singletons — so forged candidates are isolated
and attributed exactly as in per_candidate mode, at O(f·log C) extra
checks for f forgeries.

Consumers: `service.driver.HostDevice` uses `host_rlc_check` (the scalar
oracle's group math, ops/bn254_ref.py or ops/bls12_381_ref.py: the port
has no native library); `models.bn254_torch.BN254Device` (and its
BLS12-381 binding) supplies a device combined check (the MSMs and the
(G+1)-lane pairing tail on the card) and shares
`draw_scalars`/`bisect_verify`/`RlcStats`. `host_ops_for` returns None for
schemes without an ops table (the fake scheme), and their callers check
per candidate.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, NamedTuple, Sequence

BATCH_CHECK_MODES = ("per_candidate", "rlc")
SCALAR_BITS = 64


def validate_batch_check(mode: str) -> str:
    if mode not in BATCH_CHECK_MODES:
        raise ValueError(
            f"batch_check must be one of {list(BATCH_CHECK_MODES)}, got {mode!r}"
        )
    return mode


def draw_scalars(n: int, rng: random.Random | None = None) -> list[int]:
    """n fresh RLC coefficients: r_0 = 1 (free — scaling the whole equation
    by r_0^-1 shows the first candidate needs no blinding), the rest uniform
    nonzero 64-bit. Defaults to `random.SystemRandom` — the scalars are
    adversary-facing and must be unpredictable."""
    rng = rng or random.SystemRandom()
    return [1] + [rng.randrange(1, 1 << SCALAR_BITS) for _ in range(n - 1)]


@dataclass
class RlcStats:
    """Per-device RLC counters, surfaced on the device_verifier_* plane.

    rlc_launches: top-level combined checks issued (one per RLC dispatch
    with >= 2 valid candidates). bisection_ct: follow-up checks after a
    failed combined check — subset rechecks plus per-candidate oracle
    calls. bisection_depth_max: deepest recheck level reached (0 = no
    combined check has ever failed). miller_lanes / final_exp_lanes count
    the pairing work actually issued, so a smoke can assert the M+1 / 1
    contract against the 2C / C per-candidate baseline."""

    rlc_launches: int = 0
    bisection_ct: int = 0
    bisection_depth_max: int = 0
    miller_lanes: int = 0
    final_exp_lanes: int = 0


def bisect_verify(
    idxs: Sequence[int],
    combined: Callable[[list[int]], bool],
    oracle: Callable[[int], bool],
    stats: RlcStats | None = None,
) -> dict[int, bool]:
    """Verdicts for `idxs` via combined-check-then-bisect.

    `combined(subset)` runs one RLC check over the subset, drawing fresh
    scalars internally; `oracle(i)` is the per-candidate check. A passing
    combined check accepts its whole subset; a failing one splits in two
    and rechecks each half, bottoming out at the oracle — so the final
    verdict for any candidate is either "member of a passing combined
    check" (sound to 2^-64) or the oracle's own answer."""
    stats = stats if stats is not None else RlcStats()
    out: dict[int, bool] = {}

    def run(sub: list[int], depth: int) -> None:
        if depth > stats.bisection_depth_max:
            stats.bisection_depth_max = depth
        if len(sub) == 1:
            if depth:
                stats.bisection_ct += 1
            out[sub[0]] = oracle(sub[0])
            return
        if depth:
            stats.bisection_ct += 1
        else:
            stats.rlc_launches += 1
        if combined(sub):
            for i in sub:
                out[i] = True
            return
        mid = (len(sub) + 1) // 2
        run(sub[:mid], depth + 1)
        run(sub[mid:], depth + 1)

    if idxs:
        run(list(idxs), 0)
    return out


class HostRlcOps(NamedTuple):
    """Scalar-oracle group ops one scheme exposes for the host RLC check
    (affine int-tuple points, None = infinity — the scalar oracle's calling
    convention)."""

    g1_mul_batch: Callable
    g1_sum: Callable
    g1_neg: Callable
    g2_mul_batch: Callable
    g2_sum: Callable
    g2_gen: object
    pairing_check: Callable
    hash_to_g1: Callable


def _mul_batch(mul):
    return lambda pts, ks: [mul(p, k) for p, k in zip(pts, ks)]


def _sum_with(add):
    def _sum(pts):
        acc = None
        for p in pts:
            acc = p if acc is None else add(acc, p)
        return acc

    return _sum


def bn254_host_ops() -> HostRlcOps:
    from handel_tpu_torch.models.bn254 import hash_to_g1
    from handel_tpu_torch.ops import bn254_ref as bn

    return HostRlcOps(
        g1_mul_batch=_mul_batch(bn.g1_mul),
        g1_sum=_sum_with(bn.g1_add),
        g1_neg=bn.g1_neg,
        g2_mul_batch=_mul_batch(bn.g2_mul),
        g2_sum=_sum_with(bn.g2_add),
        g2_gen=bn.G2_GEN,
        pairing_check=bn.pairing_check,
        hash_to_g1=hash_to_g1,
    )


def bls12_381_host_ops() -> HostRlcOps:
    from handel_tpu_torch.models.bls12_381 import hash_to_g1
    from handel_tpu_torch.ops import bls12_381_ref as bls

    return HostRlcOps(
        g1_mul_batch=_mul_batch(bls.g1_mul),
        g1_sum=_sum_with(bls.g1_add),
        g1_neg=bls.g1_neg,
        g2_mul_batch=_mul_batch(bls.g2_mul),
        g2_sum=_sum_with(bls.g2_add),
        g2_gen=bls.G2_GEN,
        pairing_check=bls.pairing_check,
        hash_to_g1=hash_to_g1,
    )


def host_ops_for(constructor) -> HostRlcOps | None:
    """The scalar-oracle ops table for a scheme constructor, or None when
    the scheme has no RLC seam (the fake scheme) — callers fall back to
    per_candidate verification."""
    mod = type(constructor).__module__
    if "bn254" in mod:
        return bn254_host_ops()
    if "bls12_381" in mod:
        return bls12_381_host_ops()
    return None


def host_rlc_check(
    ops: HostRlcOps,
    cands: Sequence[tuple[bytes, object, object]],
    rng: random.Random | None = None,
    stats: RlcStats | None = None,
) -> bool:
    """One combined check over valid candidates (msg, apk_point, sig_point):
    fresh scalars, message-grouped G2 MSM, one product-of-pairings with
    M+1 Miller loops and one shared final exponentiation."""
    rs = draw_scalars(len(cands), rng)
    S = ops.g1_sum(ops.g1_mul_batch([c[2] for c in cands], rs))
    by_msg: dict[bytes, list[int]] = {}
    for j, (msg, _, _) in enumerate(cands):
        by_msg.setdefault(msg, []).append(j)
    pairs = []
    for msg, members in by_msg.items():
        x = ops.g2_sum(
            ops.g2_mul_batch([cands[j][1] for j in members], [rs[j] for j in members])
        )
        pairs.append((ops.hash_to_g1(msg), x))
    pairs.append((ops.g1_neg(S), ops.g2_gen))
    if stats is not None:
        stats.miller_lanes += len(pairs)
        stats.final_exp_lanes += 1
    return bool(ops.pairing_check(pairs))
