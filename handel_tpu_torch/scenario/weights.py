"""Stake-weight profiles: deterministic per-identity weight vectors — a copy of
handel_tpu/scenario/weights.py.

Every profile is a pure function of (profile, n, seed), so all processes
of a run derive the SAME weights independently — the weighted-threshold
analog of the deterministic adversary-role assignment. Non-uniform
profiles normalize to `sum(weights) == n`, keeping weighted thresholds on
the same scale as count thresholds; "count" stays exactly all-1.0 so the
weighted code path is bit-for-bit the count path.
"""

from __future__ import annotations

import random

PROFILES = ("count", "linear", "pareto", "split")


def make_weights(profile: str, n: int, seed: int = 0) -> list[float]:
    if n <= 0:
        return []
    if profile == "count":
        # all-ones, NOT normalized through float math: the strict no-op
        # profile must hand Handel exact 1.0s
        return [1.0] * n
    if profile == "linear":
        # ramp 1..2 by id: mild, deterministic inequality
        w = [1.0 + (i / (n - 1) if n > 1 else 0.0) for i in range(n)]
    elif profile == "split":
        # two castes interleaved by id parity, so stake never correlates
        # with region placement (which is id round-robin too, but over
        # >= 3 regions) or with the high-id adversary seats exclusively
        w = [1.5 if i % 2 == 0 else 0.5 for i in range(n)]
    elif profile == "pareto":
        # heavy-tailed stake: a few whales, a long tail — the realistic
        # shape for proof-of-stake committees. Seeded + capped so one
        # draw cannot dominate the total past any threshold's reach.
        rng = random.Random(f"weights|{seed}")
        w = [min(rng.paretovariate(1.5), 20.0) for _ in range(n)]
    else:
        raise ValueError(
            f"unknown weight profile {profile!r} (known: {', '.join(PROFILES)})"
        )
    total = sum(w)
    return [v * n / total for v in w]
