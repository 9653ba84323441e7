"""The port's signature store and verification pipeline against the JAX
package's: the fake scheme on both sides, the same seeded IncomingSig
sequence, exact equality of scores, bests, combined bitsets, dedup keys,
selected batches, requeues and combine routing."""

import asyncio
import random

import pytest

from handel_tpu.core import bitset as jbitset
from handel_tpu.core import crypto as jcrypto
from handel_tpu.core import handel as jhandel
from handel_tpu.core import identity as jidentity
from handel_tpu.core import partitioner as jpartitioner
from handel_tpu.core import processing as jprocessing
from handel_tpu.core import store as jstore
from handel_tpu.core.config import Config as JConfig
from handel_tpu.models import fake as jfake
from handel_tpu_torch.core import bitset, crypto, handel, identity, partitioner
from handel_tpu_torch.core import processing, store
from handel_tpu_torch.core.config import Config
from handel_tpu_torch.models import fake

# (package modules, Config) for the port, then the reference
SIDES = (
    (bitset, crypto, identity, partitioner, store, processing, handel, fake, Config),
    (jbitset, jcrypto, jidentity, jpartitioner, jstore, jprocessing, jhandel, jfake,
     JConfig),
)


def port_values(ours: dict, theirs: dict) -> dict:
    """The reference's counters under the port's keys (the port has no
    counters of the planes it has not ported); every port key must be one
    of the reference's."""
    assert set(ours) <= set(theirs), set(ours) - set(theirs)
    timed = {"sigCheckingTime"}  # wall time, not a count
    return {k: ours[k] if k in timed else theirs[k] for k in ours}


def build(side, n: int, node: int):
    bs, cr, ident, part, st, _, _, fk, _ = side
    reg = ident.ArrayRegistry(
        [ident.Identity(i, f"n-{i}", fk.FakePublic(True)) for i in range(n)])
    p = part.BinomialPartitioner(node, reg)
    s = st.SignatureStore(p, bs.BitSet, fk.FakeConstructor())
    own = bs.BitSet(1)
    own.set(0, True)
    s.store(part.IncomingSig(node, 0, cr.MultiSignature(own, fk.FakeSignature(True)),
                             is_ind=True, mapped_index=0))
    return reg, p, s


def incoming(side, p, rng: random.Random, count: int):
    """`count` seeded candidates (aggregates and individual signatures over
    the node's levels) in one package's classes; the same rng state gives
    the same sequence on both sides."""
    bs, cr, _, part, _, _, _, fk, _ = side
    out = []
    levels = p.levels()
    for _ in range(count):
        lvl = rng.choice(levels)
        lo, hi = p.range_level(lvl)
        size = hi - lo
        origin = rng.randrange(lo, hi)
        if rng.random() < 0.4:
            idx = [origin - lo]
            ind = True
        else:
            idx = sorted(rng.sample(range(size), rng.randrange(1, size + 1)))
            ind = False
        b = bs.BitSet(size)
        for i in idx:
            b.set(i, True)
        out.append(part.IncomingSig(origin, lvl, cr.MultiSignature(b, fk.FakeSignature(True)),
                                    is_ind=ind, mapped_index=idx[0] if ind else 0))
    return out


def snapshot(s, p):
    """Everything the store exposes, as wire bytes and numbers."""
    return (
        {lvl: ms.marshal() for lvl, ms in s.best_by_level.items()},
        [None if s.combined(lvl) is None else s.combined(lvl).marshal()
         for lvl in range(p.max_level())],
        None if s.full_signature() is None else s.full_signature().marshal(),
        s.full_cardinality(), s.highest, s.values(),
        {lvl: b.marshal() for lvl, b in s.indiv_verified.items()},
    )


@pytest.mark.parametrize("n,node,seed", [(8, 0, 1), (8, 5, 2), (21, 13, 3), (64, 40, 4)])
def test_store_scores_bests_and_combinations_match(n, node, seed):
    ours, theirs = build(SIDES[0], n, node), build(SIDES[1], n, node)
    seq_o = incoming(SIDES[0], ours[1], random.Random(seed), 4 * n)
    seq_t = incoming(SIDES[1], theirs[1], random.Random(seed), 4 * n)
    stored = 0
    for so, st_ in zip(seq_o, seq_t):
        score = ours[2].evaluate(so)
        assert score == theirs[2].evaluate(st_)
        if score > 0:  # as if verified
            a, b = ours[2].store(so), theirs[2].store(st_)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.marshal() == b.marshal()
            stored += 1
        assert snapshot(ours[2], ours[1]) == snapshot(theirs[2], theirs[1])
    assert stored >= 4


def test_verified_agg_cache_keys_and_lru_match():
    n = 16
    rng = random.Random(9)
    caches = [store.VerifiedAggCache(capacity=5), jstore.VerifiedAggCache(capacity=5)]
    for step in range(60):
        idx = sorted(rng.sample(range(n), rng.randrange(1, 4)))
        valid = rng.random() < 0.8
        lvl = rng.randrange(4)
        keys = []
        for side, cache in zip(SIDES, caches):
            bs, cr, fk = side[0], side[1], side[7]
            b = bs.BitSet(n)
            for i in idx:
                b.set(i, True)
            k = cache.key(lvl, cr.MultiSignature(b, fk.FakeSignature(valid)))
            keys.append(k)
            if cache.get(k) is None:
                cache.put(k, valid)
        assert keys[0] == keys[1]
        assert caches[0].values() == caches[1].values()
        assert list(caches[0]._map.items()) == list(caches[1]._map.items())
    with pytest.raises(ValueError):
        store.VerifiedAggCache(capacity=0)


def pipeline(side, cls_name, n, node, batch_size, verifier=None):
    reg, p, s = build(side, n, node)
    proc_mod = side[5]
    verified = []

    def on_verified(sp):
        verified.append((sp.origin, sp.level, sp.is_ind))
        s.store(sp)

    proc = getattr(proc_mod, cls_name)(
        p, side[7].FakeConstructor(), b"m", reg.public_keys(), s, on_verified,
        batch_size=batch_size, verifier=verifier, max_pending=24,
    )
    return p, s, proc, verified


@pytest.mark.parametrize("cls_name", ["BatchProcessing", "FifoProcessing"])
@pytest.mark.parametrize("n,node,seed,batch", [(8, 3, 5, 2), (21, 0, 6, 4), (64, 33, 7, 8)])
def test_selected_batches_match(cls_name, n, node, seed, batch):
    """The same candidates in, the same batches out, in the same order; each
    batch is published (as verified) before the next selection. Candidates
    arrive 30 at a time, so beyond 8 nodes the queue overflows its 24-entry
    bound on the way."""
    sides = [pipeline(side, cls_name, n, node, batch) for side in SIDES]
    seqs = [incoming(side, sides[i][0], random.Random(seed), 3 * n)
            for i, side in enumerate(SIDES)]
    rounds = 0
    for chunk in range(0, 3 * n, 30):
        for (p, s, proc, _), seq in zip(sides, seqs):
            for sp in seq[chunk:chunk + 30]:
                proc.add(sp)
        while True:
            batches = [proc._select_batch() for _, _, proc, _ in sides]
            assert [[(sp.origin, sp.level, sp.is_ind, sp.ms.marshal()) for sp in b]
                    for b in batches][0] == \
                [[(sp.origin, sp.level, sp.is_ind, sp.ms.marshal()) for sp in b]
                 for b in batches][1]
            if not batches[0]:
                break
            rounds += 1
            for (_, _, proc, _), b in zip(sides, batches):
                for sp in b:
                    proc.on_verified(sp)
                proc._dirty = True
            ours, theirs = sides[0][2].values(), sides[1][2].values()
            assert ours == port_values(ours, theirs)
    assert rounds > 1
    assert sides[0][3] == sides[1][3]
    assert (sides[0][2].sig_dropped_overflow > 0) == (n > 8)


def test_requeue_cap_matches():
    """A verifier that always fails: each candidate is tried 1 + max_retries
    times on both sides, then dropped with the same counters."""

    async def always_fail(msg, pubkeys, requests):
        raise RuntimeError("dead device")

    async def drive(side):
        p, s, proc, verified = pipeline(side, "BatchProcessing", 8, 0, 2, always_fail)
        sps = incoming(side, p, random.Random(12), 5)
        proc.start()
        for sp in sps:
            proc.add(sp)
        for _ in range(200):
            await asyncio.sleep(0.005)
            if not proc._queue_len():
                break
        proc.stop()
        return proc.max_retries, [sp.verify_tries for sp in sps], proc.values(), verified

    ours = asyncio.run(drive(SIDES[0]))
    theirs = asyncio.run(drive(SIDES[1]))
    assert ours[2] == port_values(ours[2], theirs[2])
    assert ours[:2] + ours[3:] == theirs[:2] + theirs[3:]
    assert max(ours[1]) == ours[0] + 1


class PointSig:
    """A signature with a `point` (an int; combine adds), so CombineShim
    routes groups of it to the device hook."""

    def __init__(self, point):
        self.point = point

    def combine(self, other):
        return PointSig(self.point + other.point)

    def __eq__(self, other):
        return isinstance(other, PointSig) and self.point == other.point


def test_combine_shim_routing_matches():
    """The same groups through both shims with a recording device hook that
    declines some groups (None entries) and, once, the whole call (None):
    the same groups reach the hook, the same sums come out, the same
    counters move."""
    rng = random.Random(4)
    groups = [[PointSig(rng.randrange(100)) for _ in range(rng.randrange(1, 10))]
              for _ in range(40)]
    runs = []
    for mod in (processing, jprocessing):
        calls = []

        def hook(gs, calls=calls):
            calls.append([[p for p in g] for g in gs])
            if len(calls) % 5 == 0:
                return None  # the device does not exist yet
            return [None if len(g) == 7 else sum(g) for g in gs]

        shim = mod.CombineShim(hook, min_device_points=4)
        out = [shim.combine_many(g).point for g in groups[:20]]
        for g in groups[20:30]:
            shim.accumulate(g)
        out += [s.point for s in shim.flush()]
        shim.accumulate(groups[30])
        out.append(shim.combine_many(groups[31]).point)
        out += [s.point for s in shim.flush()]
        runs.append((calls, out, shim.values()))
        assert out[:20] == [sum(s.point for s in g) for g in groups[:20]]
    assert runs[0] == runs[1]
    assert runs[0][2]["combineDeviceGroups"] > 0 and runs[0][2]["combineHostGroups"] > 0


class DeviceCombineConstructor(fake.FakeConstructor):
    def device_combine(self, groups):
        return None


def test_combine_shim_for_constructor_matches():
    assert processing.CombineShim.for_constructor(fake.FakeConstructor()) is None
    assert jprocessing.CombineShim.for_constructor(jfake.FakeConstructor()) is None
    shim = processing.CombineShim.for_constructor(DeviceCombineConstructor(),
                                                  min_device_points=1)
    assert shim is not None and shim.min_device_points == 2


@pytest.mark.parametrize("n,seed", [(8, 1), (21, 2), (100, 3)])
def test_levels_and_peer_orders_match(n, seed):
    """create_levels with the same seeded rand: the same shuffled peers and
    send sizes per level, with and without shuffling."""
    for node in range(0, n, max(1, n // 7)):
        for disable in (False, True):
            got = []
            for side in SIDES:
                reg, p, _ = build(side, n, node)
                cfg = side[8](rand=random.Random(seed + node), disable_shuffling=disable)
                levels = side[6].create_levels(cfg, p)
                got.append({lid: ([x.id for x in lvl.nodes], lvl.send_expected_full_size,
                                  lvl.send_pos, lvl.send_started)
                            for lid, lvl in levels.items()})
            assert got[0] == got[1]
