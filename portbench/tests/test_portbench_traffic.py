"""The range mix's generator: deterministic from the seed, and drawing the
stated mix."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import spec
from portbench.reference import curves, verdicts

SEED = 2**33 + 12345  # past 32 bits, as the check's seeds are


def pool_of(seed=SEED, n=512, curve="bn254", **over):
    mix = spec.load_mix("range")
    params = dict(mix["params"], **over)
    return spec.generator(mix).generate(curves.curve(curve), n, params, seed), params


def test_the_same_seed_gives_the_same_inputs():
    a, _ = pool_of()
    b, _ = pool_of()
    c, _ = pool_of(seed=SEED + 1)
    assert a.sks == b.sks and a.pks == b.pks and a.sigs == b.sigs
    assert np.array_equal(a.words, b.words)
    assert a.message == b.message
    assert a.message != c.message
    assert not np.array_equal(a.words, c.words)


def test_the_pool_draws_the_stated_mix():
    n = 512
    pool, p = pool_of(n=n)
    lanes = n * p["lanes_per_key"]
    assert pool.lanes == lanes
    assert len(pool.sigs) == lanes * p["in_flight_launches"]
    assert pool.request_candidates == 16 and pool.requests == len(pool.sigs) // 16
    assert set(np.unique(pool.sizes)) <= {n // 8, n // 4, n // 2}
    assert pool.holes.min() == 0 and pool.holes.max() == 7
    # forgeries: exactly one in forged_every, and the reference rejects
    # exactly those
    assert pool.forged.sum() == len(pool.sigs) // p["forged_every"]
    ref = verdicts.verdicts(curves.curve("bn254"), n, pool.sks, pool.candidate_messages(),
                            pool.words, pool.sigs)
    assert [not v for v in ref] == list(pool.forged)
    # every candidate is a range of its size with its holes: bits set are
    # size - holes, inside [lo, lo + size)
    bits = np.unpackbits(pool.words.view(np.uint8), axis=1, count=n, bitorder="little")
    assert np.array_equal(bits.sum(axis=1), pool.sizes - pool.holes)
    # sessions: request r belongs to session r % 8, all on one message
    assert {pool.session_of(r) for r in range(pool.requests)} == set(range(8))
    assert len(set(pool.candidate_messages())) == 1


def test_no_two_candidates_of_a_session_share_their_content():
    pool, _ = pool_of(n=16, lanes_per_key=1, request_candidates=4, sessions=2)
    seen = set()
    for j in range(len(pool.sigs)):
        key = (pool.session_of(j // 4), pool.words[j].tobytes(), pool.sigs[j])
        assert key not in seen
        seen.add(key)


def test_a_session_holds_no_more_than_the_mixs_pending_bound():
    """Request r belongs to session r % sessions, so one session name holds
    at most an eighth of the pool at once: the mix's admission bound a
    session covers that at the cells' largest registry, and the default
    of 4,096 would not."""
    mix = spec.load_mix("range")
    p = mix["params"]
    lanes = 4096 * p["lanes_per_key"]
    share = lanes * p["in_flight_launches"] // p["sessions"]
    assert share <= p["max_pending_per_session"]
    assert share > 4096


@pytest.mark.parametrize("curve", ["bn254", "bls12-381"])
def test_keys_and_signatures_are_points_of_the_curve(curve):
    pool, _ = pool_of(n=64, curve=curve)
    c = curves.curve(curve)
    assert all(c.g2.on_curve(pk) for pk in pool.pks[:8])
    assert all(c.g1.on_curve(s) for s in pool.sigs[:8])
