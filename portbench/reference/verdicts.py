"""The plain reference of a verify verdict, and its control.

A candidate (message m, signer bitset S, aggregate signature sigma) is
valid when e(H(m), sum_{i in S} X_i) == e(sigma, G2). The benchmark made
every key itself, X_i = x_i * G2 from secret scalars x_i it holds, so the
left side is e(H(m), G2)^(sum x_i) and, e(., G2) being injective on the
prime-order group G1, the check is exactly

    sigma == (sum_{i in S} x_i) * H(m)

on G1. That is what `verdicts` computes, from the candidate's bitset words
as handed to the program, its signature point and the keys: one sum of
scalars and one fixed-base product a candidate, no pairing. An empty
signer set is invalid, as the program treats it. Nothing here reads
anything the program made.

`control_verdicts` is the same check with one guarantee broken: the
aggregate key is taken over the candidate's range hull (its first to its
last signer) with the holes left in, the step a launch that drops its
hole patch would take. It has to come out wrong on the traffic's
candidates with holes.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.curves import FixedBase

BLOCK = 1024  # candidates unpacked at a time


def _scalars(words: np.ndarray, n: int, sks, hull: bool) -> list:
    """Each candidate's summed secret scalar (0 for an empty set)."""
    sk = np.array(sks, np.int64)
    out: list = []
    for i in range(0, len(words), BLOCK):
        bits = np.unpackbits(
            words[i : i + BLOCK].view(np.uint8), axis=1, count=n, bitorder="little"
        ).astype(bool)
        if hull:
            any_ = bits.any(axis=1)
            first = bits.argmax(axis=1)
            last = n - 1 - bits[:, ::-1].argmax(axis=1)
            idx = np.arange(n)
            bits = (idx >= first[:, None]) & (idx <= last[:, None]) & any_[:, None]
        # sums below 2^63: the keys are small scalars
        out.extend(int(s) if b else 0 for s, b in zip(bits @ sk, bits.any(axis=1)))
    return out


def _check(curve, scalars, messages, sigs) -> list:
    g1 = curve.g1
    bits = max(1, max(scalars, default=1).bit_length())
    tables: dict = {}
    out = []
    for s, m, sig in zip(scalars, messages, sigs):
        if s == 0 or sig is None:
            out.append(False)
            continue
        if m not in tables:
            tables[m] = FixedBase(g1, curve.hash_to_g1(m), bits)
        out.append(g1.equals_affine(tables[m].mul(s), sig))
    return out


def verdicts(curve, n: int, sks, messages, words, sigs) -> list:
    """The reference verdict of each candidate: `messages`, `words` (N, W)
    uint64 and `sigs` (affine G1) are per candidate, `sks` the registry's
    secret scalars."""
    return _check(curve, _scalars(words, n, sks, hull=False), messages, sigs)


def control_verdicts(curve, n: int, sks, messages, words, sigs) -> list:
    """The control: `verdicts` with the holes of each range left in."""
    return _check(curve, _scalars(words, n, sks, hull=True), messages, sigs)
