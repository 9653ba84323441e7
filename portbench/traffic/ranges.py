"""Handel verify traffic: a pool of candidate aggregates over contiguous
signer ranges, replayed by a closed loop of clients.

The candidate distribution is a frozen copy of
`handel_tpu_torch/scripts/launch_problem.py` `build_problem` at commit
3760aa89b03e87d3430f6fe2b66b6553ac17ffbc (itself the reference's
`bench.py` `build_problem`): keys from small scalars drawn by
`random.Random(seed)`, then per candidate a range of n * f keys for f drawn
from `range_fractions`, starting at randrange(0, n - size), with
randrange(0, min(miss_k, size - 1)) holes sampled inside it, signed by the
signers' summed scalar. The copy lives here so that no change to the
program moves the yardstick.

What it adds to that distribution, each a parameter of the mix:

  sessions, request_candidates   the pool is cut into requests of
                                 `request_candidates` (one node's verify
                                 batch); request r belongs to session
                                 r % sessions
  lanes_per_key                  launch width = registry size * this
  in_flight_launches             pool size = launch width * this: the
                                 closed loop keeps that many candidates in
                                 flight
  forged_every                   exactly pool // forged_every candidates,
                                 drawn from the seed, carry a valid G1
                                 point over the wrong signer set (their
                                 signers' points plus one non-signer's), as
                                 the reference's `invalid_signer` role sends
  key_bits                       secret scalars are below 2^key_bits

Every session signs the one message of the run. No two candidates of one
session share their content, so the service's per-session dedup never
answers one from its cache.

A signature is built as a sum of points, not as one scalar product: with
K_i = x_i * H(m) and the prefix sums Q_i of the K, a range [lo, hi) with
holes signs Q_hi - Q_lo - (the holes' K), and all candidates' sums are
taken together in affine rounds that share one field inversion
(Montgomery's trick). The reference checks each against its scalar
product instead (portbench/reference/verdicts.py).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np

from portbench.reference.curves import FixedBase

BLOCK = 4096  # candidates whose bitsets are built at a time


@dataclass
class Pool:
    """The inputs of one run, all made from the seed.

    `words` (N, W) uint64 are the candidates' bitset words as the port's
    BitSet keeps them (bit i of the registry = bit i % 64 of word i // 64);
    `sigs` their aggregate signatures (affine G1); `forged`, `sizes` and
    `holes` the generator's own record, used only by tests of the mix: the
    reference works every verdict out again from `words`, `sigs` and the
    keys."""

    n: int
    lanes: int
    request_candidates: int
    sessions: int
    sks: list
    pks: list
    message: bytes
    words: np.ndarray
    sigs: list
    forged: np.ndarray
    sizes: np.ndarray
    holes: np.ndarray

    @property
    def requests(self) -> int:
        return len(self.sigs) // self.request_candidates

    def session_of(self, request: int) -> int:
        return request % self.sessions

    def candidate_messages(self) -> list:
        """Each candidate's message, in pool order."""
        return [self.message] * len(self.sigs)


def lanes_for(registry: int, params: dict) -> int:
    return max(1, int(round(registry * params["lanes_per_key"])))


def _words(n: int, draws) -> np.ndarray:
    """(len(draws), W) uint64 bitset words of (lo, hi, holes, _) draws."""
    W = (n + 63) // 64
    out = np.zeros((len(draws), W), np.uint64)
    idx = np.arange(n)
    for b in range(0, len(draws), BLOCK):
        chunk = draws[b : b + BLOCK]
        lo = np.array([d[0] for d in chunk])[:, None]
        hi = np.array([d[1] for d in chunk])[:, None]
        bits = (idx >= lo) & (idx < hi)
        rows = [j for j, d in enumerate(chunk) for _ in d[2]]
        cols = [h for d in chunk for h in d[2]]
        bits[rows, cols] = False
        packed = np.packbits(bits, axis=1, bitorder="little")
        buf = np.zeros((len(chunk), W * 8), np.uint8)
        buf[:, : packed.shape[1]] = packed
        out[b : b + len(chunk)] = buf.view(np.uint64)
    return out


def _sum_points(group, terms: list) -> list:
    """Each list of affine points (signed terms already negated) summed, all
    lists at once: pairwise affine additions a round, the round's slopes
    sharing one inversion; a pair that meets a doubling or an inverse goes
    through the Jacobian formulas."""
    F = group.F
    p = F.p
    terms = [list(t) for t in terms]
    while True:
        pairs = [(j, k) for j, t in enumerate(terms) for k in range(0, len(t) - 1, 2)]
        if not pairs:
            break
        dx = [(terms[j][k + 1][0] - terms[j][k][0]) % p for j, k in pairs]
        # Montgomery's batch inversion over the nonzero differences
        pre, acc = [], 1
        for d in dx:
            pre.append(acc)
            if d:
                acc = acc * d % p
        inv = pow(acc, -1, p)
        invs = [0] * len(dx)
        for i in range(len(dx) - 1, -1, -1):
            if dx[i]:
                invs[i] = inv * pre[i] % p
                inv = inv * dx[i] % p
        new = [[] for _ in terms]
        for (j, k), d, di in zip(pairs, dx, invs):
            (x1, y1), (x2, y2) = terms[j][k], terms[j][k + 1]
            if d:
                lam = (y2 - y1) * di % p
                x3 = (lam * lam - x1 - x2) % p
                new[j].append((x3, (lam * (x1 - x3) - y1) % p))
            else:
                pt = group.to_affine([group.add(group.jac((x1, y1)), group.jac((x2, y2)))])[0]
                if pt is not None:
                    new[j].append(pt)
        for j, t in enumerate(terms):
            if len(t) % 2:
                new[j].append(t[-1])
        terms = new
    return [t[0] if t else None for t in terms]


def _neg(pt, p):
    return None if pt is None else (pt[0], -pt[1] % p)


def generate(curve, registry: int, params: dict, seed: int) -> Pool:
    """The pool for `registry` keys on `curve` (portbench.reference.curves)
    under the mix's `params`, from `random.Random(seed)`."""
    n = registry
    lanes = lanes_for(n, params)
    R = int(params["request_candidates"])
    total = lanes * int(params["in_flight_launches"])
    if total % R:
        raise ValueError(f"pool of {total} candidates is not whole requests of {R}")
    sessions = int(params["sessions"])
    miss_k = int(params["miss_k"])
    key_bits = int(params["key_bits"])
    g1 = curve.g1
    p = g1.F.p
    rng = random.Random(seed)

    # build_problem's order: the keys first
    sks = [rng.randrange(1, 1 << key_bits) for _ in range(n)]
    table = FixedBase(curve.g2, curve.g2.gen, key_bits)
    pks = curve.g2.to_affine([table.mul(k) for k in sks])
    message = f"portbench {seed} message 0".encode()
    # K_i = x_i * H(m), and Q_i = the sum of the K below i
    h = FixedBase(g1, curve.hash_to_g1(message), key_bits)
    K = g1.to_affine([h.mul(x) for x in sks])
    Q, acc = [None], None
    for i in range(n):
        acc = g1.add_affine(acc, K[i])
        Q.append(acc)
    Q = g1.to_affine(Q)
    forged_idx = set(rng.sample(range(total), total // int(params["forged_every"])))
    fractions = params["range_fractions"]

    def draw(j):
        size = rng.choice([max(1, int(n * f)) for f in fractions])
        lo = rng.randrange(0, n - size)
        hi = lo + size
        max_holes = min(miss_k, size - 1)  # at least one signer stays
        holes = rng.sample(
            range(lo, hi), rng.randrange(0, max_holes) if max_holes > 0 else 0
        )
        e = None
        if j in forged_idx:
            # the wrong signer set: one member outside it adds his point
            while True:
                e = rng.randrange(n)
                if not (lo <= e < hi) or e in holes:
                    break
        return (lo, hi, holes, e)

    W = (n + 63) // 64
    draws = [draw(j) for j in range(total)]
    words = _words(n, draws)
    # no two candidates of one session alike: redraw a repeat
    seen: set = set()
    for j in range(total):
        while True:
            key = ((j // R) % sessions, words[j].tobytes(), draws[j][3])
            if key not in seen:
                break
            draws[j] = draw(j)
            lo, hi, holes, _e = draws[j]
            bits = np.zeros((W * 64,), bool)
            bits[lo:hi] = True
            bits[holes] = False
            words[j] = np.packbits(bits, bitorder="little").view(np.uint64)
        seen.add(key)

    terms = []
    for lo, hi, holes, e in draws:
        t = [Q[hi], _neg(Q[lo], p)] + [_neg(K[h], p) for h in holes]
        if e is not None:
            t.append(K[e])
        terms.append([pt for pt in t if pt is not None])
    sigs = _sum_points(g1, terms)
    return Pool(
        n=n, lanes=lanes, request_candidates=R, sessions=sessions, sks=sks, pks=pks,
        message=message, words=words, sigs=sigs,
        forged=np.array([d[3] is not None for d in draws]),
        sizes=np.array([d[1] - d[0] for d in draws]),
        holes=np.array([len(d[2]) for d in draws]),
    )
