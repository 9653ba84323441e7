"""The port's protocol-core building blocks against the JAX package's, with
the same seeded inputs and exact equality: bitsets and their wire bytes,
the seeded shuffle, the binomial partitioner, packets, timeouts, peer
scoring, config defaults, histograms, multisignatures and host keygen."""

import asyncio
import dataclasses
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from handel_tpu.core import bitset as jbitset
from handel_tpu.core import config as jconfig
from handel_tpu.core import crypto as jcrypto
from handel_tpu.core import identity as jidentity
from handel_tpu.core import net as jnet
from handel_tpu.core import partitioner as jpartitioner
from handel_tpu.core import penalty as jpenalty
from handel_tpu.core import report as jreport
from handel_tpu.core import timeout as jtimeout
from handel_tpu.core import trace as jtrace
from handel_tpu.models import bn254 as jbn254
from handel_tpu.models import fake as jfake
from handel_tpu.utils import math as jmath
from handel_tpu_torch.core import bitset, config, crypto, identity, net, partitioner
from handel_tpu_torch.core import penalty, report, timeout, trace
from handel_tpu_torch.models import bn254, fake
from handel_tpu_torch.utils import math as pmath


def pair_of_bitsets(n: int, idx):
    """The same bits in the port's BitSet and the reference's."""
    a, b = bitset.BitSet(n), jbitset.BitSet(n)
    for i in idx:
        a.set(i, True)
        b.set(i, True)
    return a, b


def same_bits(a, b) -> bool:
    return len(a) == len(b) and a.indices() == list(b.indices())


@st.composite
def two_bitsets(draw):
    n = draw(st.integers(1, 300))
    sets = [draw(st.sets(st.integers(0, n - 1), max_size=n)) for _ in range(2)]
    return n, sets


@settings(max_examples=60, deadline=None)
@given(two_bitsets())
def test_bitset_wire_and_algebra_match(case):
    n, (s1, s2) = case
    a1, b1 = pair_of_bitsets(n, sorted(s1))
    a2, b2 = pair_of_bitsets(n, sorted(s2))
    assert a1.marshal() == b1.marshal()
    assert a1.words().tobytes() == b1.words().tobytes()
    for op in ("or_", "and_", "xor"):
        assert getattr(a1, op)(a2).marshal() == getattr(b1, op)(b2).marshal()
    for q in ("is_superset", "intersection_cardinality"):
        assert getattr(a1, q)(a2) == getattr(b1, q)(b2)
    for q in ("cardinality", "all", "none", "any", "next_set"):
        assert getattr(a1, q)() == getattr(b1, q)()
    assert (a1.mask_bool(n + 5) == b1.mask_bool(n + 5)).all()
    # cross decodes, both ways
    got, used = bitset.BitSet.unmarshal(b1.marshal())
    assert same_bits(got, b1) and used == len(b1.marshal())
    back, _ = jbitset.BitSet.unmarshal(a1.marshal())
    assert same_bits(back, a1)
    # the store's merge primitive
    lo = len(s1) % max(1, n // 2)
    wide_a, wide_b = bitset.BitSet(2 * n), jbitset.BitSet(2 * n)
    wide_a.or_embed(a2, lo)
    wide_b.or_embed(b2, lo)
    assert wide_a.marshal() == wide_b.marshal()
    wide_a.or_embed(bitset.AllOnesBitSet(n // 2), n)
    wide_b.or_embed(jbitset.AllOnesBitSet(n // 2), n)
    assert wide_a.marshal() == wide_b.marshal()


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 300), st.integers(0, 300))
def test_all_ones_bitset_matches(n, other_seed):
    a, b = bitset.AllOnesBitSet(n), jbitset.AllOnesBitSet(n)
    assert a.marshal() == b.marshal()
    assert list(a.indices()) == list(b.indices())
    rng = random.Random(other_seed)
    idx = sorted(rng.sample(range(n), rng.randrange(0, n + 1)))
    pa, pb = pair_of_bitsets(n, idx)
    assert a.is_superset(pa) == b.is_superset(pb)
    assert a.intersection_cardinality(pa) == b.intersection_cardinality(pb)
    assert (a.cardinality(), a.all(), a.none(), a.any(), a.next_set(n - 1)) == (
        b.cardinality(), b.all(), b.none(), b.any(), b.next_set(n - 1))


@pytest.mark.parametrize("n,density", [(0xFFFF, 0.001), (70_000, 0.6), (200_000, 0.0)])
def test_bitset_extended_wire_forms_match(n, density):
    """The 0xFFFF escape: the sparse (varint-delta) and dense extended forms."""
    rng = np.random.default_rng(n)
    idx = np.nonzero(rng.random(n) < density)[0].tolist()
    a, b = pair_of_bitsets(n, idx)
    wire = a.marshal()
    assert wire == b.marshal()
    got, used = jbitset.BitSet.unmarshal(wire)
    assert used == len(wire) and got.indices() == idx
    got, used = bitset.BitSet.unmarshal(b.marshal())
    assert used == len(wire) and got.indices() == idx


@pytest.mark.parametrize("wire", [b"", b"\x00", b"\x00\x09\xff", b"\xff\xff\x01",
                                  b"\xff\xff\x07\x00\x00\x00\x10\x05",
                                  b"\xff\xff\x01\x00\x00\x00\x10\x02\x80"])
def test_bitset_rejects_what_the_reference_rejects(wire):
    with pytest.raises(ValueError):
        jbitset.BitSet.unmarshal(wire)
    with pytest.raises(ValueError):
        bitset.BitSet.unmarshal(wire)


def test_math_helpers_match():
    for n in range(0, 300):
        assert pmath.log2_ceil(n) == jmath.log2_ceil(n)
        assert pmath.pow2(n % 40) == jmath.pow2(n % 40)
        assert pmath.is_set(n, n % 9) == jmath.is_set(n, n % 9)


@pytest.mark.parametrize("seed", [0, 1, 7, 2024])
def test_shuffle_orders_match(seed):
    items = list(range(97))
    other = list(items)
    identity.shuffle(items, random.Random(seed))
    jidentity.shuffle(other, random.Random(seed))
    assert items == other


def registries(n: int):
    ours = identity.ArrayRegistry(
        [identity.Identity(i, f"a-{i}", fake.FakePublic(True)) for i in range(n)])
    theirs = jidentity.ArrayRegistry(
        [jidentity.Identity(i, f"a-{i}", jfake.FakePublic(True)) for i in range(n)])
    return ours, theirs


def outcome(fn, *args):
    """fn's value, or the name of the exception it raised."""
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e).__name__
    if isinstance(out, (jidentity.RegistrySlice, identity.RegistrySlice)):
        return [i.id for i in out]
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 8, 21, 64, 100])
def test_partitioner_ranges_and_levels_match(n):
    ours, theirs = registries(n)
    for node in range(n):
        p = partitioner.BinomialPartitioner(node, ours)
        q = jpartitioner.BinomialPartitioner(node, theirs)
        assert p.max_level() == q.max_level()
        assert p.levels() == q.levels()
        for lvl in range(-1, p.max_level() + 3):
            for fn in ("range_level", "range_level_inverse", "size_of", "identities_at"):
                assert outcome(getattr(p, fn), lvl) == outcome(getattr(q, fn), lvl), (
                    node, lvl, fn)
            for gid in (0, node, n - 1, n):
                assert outcome(p.index_at_level, gid, lvl) == outcome(
                    q.index_at_level, gid, lvl)


def test_partitioner_combine_matches():
    """combine / combine_full over per-level bests, with the fake scheme."""
    n = 21
    ours, theirs = registries(n)
    rng = random.Random(5)
    for node in (0, 6, 20):
        p = partitioner.BinomialPartitioner(node, ours)
        q = jpartitioner.BinomialPartitioner(node, theirs)
        sigs_p, sigs_q = [], []
        for lvl in [0] + p.levels():
            size = 1 if lvl == 0 else p.size_of(lvl)
            idx = sorted(rng.sample(range(size), rng.randrange(1, size + 1)))
            a, b = pair_of_bitsets(size, idx)
            sigs_p.append(partitioner.IncomingSig(
                -1, lvl, crypto.MultiSignature(a, fake.FakeSignature(True))))
            sigs_q.append(jpartitioner.IncomingSig(
                -1, lvl, jcrypto.MultiSignature(b, jfake.FakeSignature(True))))
        for lvl in range(0, p.max_level()):
            # as the store's combined(lvl): levels <= lvl, sized for lvl + 1
            x = p.combine([s for s in sigs_p if s.level <= lvl], lvl + 1)
            y = q.combine([s for s in sigs_q if s.level <= lvl], lvl + 1)
            assert x.marshal() == y.marshal()
        assert p.combine_full(sigs_p).marshal() == q.combine_full(sigs_q).marshal()


PACKETS = [
    dict(origin=3, level=2, multisig=b"\x00\x04\x0b" + bytes(8)),
    dict(origin=0, level=0, multisig=b"", individual_sig=bytes(range(8)), sent_ts=12.5),
    dict(origin=2**31 - 1, level=255, multisig=bytes(300), individual_sig=b"x" * 64,
         sent_ts=1.7e9, span_id=(7 << 40) | 3, hop=1),
    dict(origin=-5, level=1, multisig=b"ab", span_id=2**64 - 1),
]


@pytest.mark.parametrize("fields", PACKETS, ids=range(len(PACKETS)))
def test_packet_bytes_and_cross_decodes_match(fields):
    ours, theirs = net.Packet(**fields), jnet.Packet(**fields)
    wire = ours.encode()
    assert wire == theirs.encode()
    assert dataclasses.asdict(jnet.Packet.decode(wire)) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(net.Packet.decode(theirs.encode())) == dataclasses.asdict(ours)
    # truncated trailers degrade to unlinked on both sides; truncated
    # payloads raise on both
    for cut in range(1, 12):
        short = wire[:-cut]
        got = [outcome(lambda w=short, m=m: dataclasses.asdict(m.decode(w)))
               for m in (net.Packet, jnet.Packet)]
        assert got[0] == got[1], cut


def test_timeout_schedules_match(monkeypatch):
    """LinearTimeout starts level i at i*period on both sides: the same
    start_level calls and sleeps in the same order; InfiniteTimeout none."""

    def schedule(module, levels, period):
        events = []

        class Recorder:
            def start_level(self, lvl):
                events.append(("start", lvl))

        async def fake_sleep(s):
            events.append(("sleep", s))

        async def go():
            monkeypatch.setattr(asyncio, "sleep", fake_sleep)
            t = module.LinearTimeout(Recorder(), levels, period)
            t.start()
            await t._task
            t.stop()
            inf = module.InfiniteTimeout(Recorder(), levels)
            inf.start()
            inf.stop()
            monkeypatch.undo()

        asyncio.run(go())
        return events

    for levels, period in (([1, 2, 3, 5], 0.05), ([], 0.01), ([4], 1.0)):
        assert schedule(timeout, levels, period) == schedule(jtimeout, levels, period)


def test_peer_scorer_decisions_match():
    """One event sequence, an injected clock: the same scores, demotions,
    bans and counters, including the ban-capacity refusal."""
    now = [0.0]
    kw = dict(ban_capacity=2, clock=lambda: now[0])
    ours, theirs = penalty.PeerScorer(**kw), jpenalty.PeerScorer(**kw)
    rng = random.Random(11)
    for step in range(400):
        now[0] += rng.choice([0.0, 0.1, 1.0, 5.0])
        peer = rng.randrange(6)
        weight = rng.choice([penalty.WEIGHT_VERIFY_FAIL, penalty.WEIGHT_PARSE_FAIL])
        ours.report(peer, weight)
        theirs.report(peer, weight)
        for q in range(6):
            assert ours.score(q) == theirs.score(q), step
            assert ours.demoted(q) == theirs.demoted(q)
            assert ours.banned(q) == theirs.banned(q)
        assert ours.values() == theirs.values()
    assert (penalty.DEFAULT_DEMOTE_THRESHOLD, penalty.DEFAULT_BAN_THRESHOLD) == (
        jpenalty.DEFAULT_DEMOTE_THRESHOLD, jpenalty.DEFAULT_BAN_THRESHOLD)
    for bad in (dict(demote_threshold=0), dict(ban_threshold=1, demote_threshold=2)):
        with pytest.raises(ValueError):
            penalty.PeerScorer(**bad)
        with pytest.raises(ValueError):
            jpenalty.PeerScorer(**bad)


def test_config_defaults_match():
    ours, theirs = config.Config(), jconfig.Config()
    names = [f.name for f in dataclasses.fields(ours)]
    assert set(names) <= {f.name for f in dataclasses.fields(theirs)}
    for name in names:
        a, b = getattr(ours, name), getattr(theirs, name)
        if name == "rand":
            assert type(a) is type(b) is random.Random
            continue
        if callable(a) or callable(b):
            assert getattr(a, "__name__", a) == getattr(b, "__name__", b), name
        elif name == "logger":
            assert a._log.name == b._log.name
        else:
            assert a == b, name
    for n in (1, 2, 7, 8, 100, 4096):
        assert config.default_config(n).contributions == jconfig.default_config(n).contributions
        c = config.Config(contributions=3)
        assert config.merge_with_default(c, n).contributions == 3
        for perc in (0, 33, 51, 100):
            assert config.percentage_to_contributions(perc, n) == \
                jconfig.percentage_to_contributions(perc, n)


def test_log_histogram_matches():
    rng = random.Random(3)
    ours, theirs = trace.LogHistogram(), jtrace.LogHistogram()
    other, jother = trace.LogHistogram(), jtrace.LogHistogram()
    for _ in range(500):
        v = rng.lognormvariate(-3, 2)
        ours.add(v)
        theirs.add(v)
        w = rng.random() * 10
        other.add(w)
        jother.add(w)
    ours.merge(other)
    theirs.merge(jother)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
    assert (ours.counts, ours.count, ours.sum) == (theirs.counts, theirs.count, theirs.sum)


def test_warn_once_matches():
    class Log:
        def __init__(self):
            self.lines = []

        def warn(self, *a):
            self.lines.append(("warn",) + a)

        def debug(self, *a):
            self.lines.append(("debug",) + a)

    lo, lt = Log(), Log()
    ours, theirs = report.WarnOnce(lo), jreport.WarnOnce(lt)
    for key in ["a", "b", "a", "a", "c", "b"]:
        ours.warn(key, 1)
        theirs.warn(key, 1)
    assert lo.lines == lt.lines and ours.values() == theirs.values()


def test_multisignature_wire_matches_both_schemes():
    n = 13
    a, b = pair_of_bitsets(n, [0, 4, 12])
    ours = crypto.MultiSignature(a, fake.FakeSignature(True))
    theirs = jcrypto.MultiSignature(b, jfake.FakeSignature(True))
    assert ours.marshal() == theirs.marshal()
    back = crypto.MultiSignature.unmarshal(theirs.marshal(), fake.FakeConstructor())
    assert back.marshal() == ours.marshal()
    sk, _ = bn254.new_keypair(seed=3)
    jsk, _ = jbn254.new_keypair(seed=3)
    ours = crypto.MultiSignature(a, sk.sign(b"m"))
    theirs = jcrypto.MultiSignature(b, jsk.sign(b"m"))
    assert ours.marshal() == theirs.marshal()
    with pytest.raises(ValueError):
        crypto.MultiSignature.unmarshal(ours.marshal()[:-1], bn254.BN254Constructor())


def test_verify_multisignature_matches_on_fake_registry():
    n = 8
    ours, theirs = registries(n)
    for idx, valid in (([0, 1, 5], True), ([], True), ([2], False)):
        a, b = pair_of_bitsets(n, idx)
        x = crypto.verify_multisignature(
            b"m", crypto.MultiSignature(a, fake.FakeSignature(valid)), ours,
            fake.FakeConstructor())
        y = jcrypto.verify_multisignature(
            b"m", jcrypto.MultiSignature(b, jfake.FakeSignature(valid)), theirs,
            jfake.FakeConstructor())
        assert x == y
    short, jshort = pair_of_bitsets(n - 1, [0])
    assert not crypto.verify_multisignature(
        b"m", crypto.MultiSignature(short, fake.FakeSignature()), ours, fake.FakeConstructor())


@pytest.mark.parametrize("i", range(8))
def test_bn254_keygen_matches(i):
    sk, pk = bn254.BN254Scheme().keygen(i)
    jsk, jpk = jbn254.BN254Scheme().keygen(i)
    assert sk.marshal() == jsk.marshal()
    assert pk.marshal() == jpk.marshal()


def test_fake_scheme_matches():
    ours, theirs = fake.FakeScheme(), jfake.FakeScheme()
    for i in range(4):
        (s, p), (js, jp) = ours.keygen(i), theirs.keygen(i)
        assert (s.marshal(), p.marshal()) == (js.marshal(), jp.marshal())
    for v in (True, False):
        wire = fake.FakeSignature(v).marshal()
        assert wire == jfake.FakeSignature(v).marshal()
        assert ours.constructor.unmarshal_signature(wire).valid == v
    assert ours.constructor.signature_size() == theirs.constructor.signature_size()
