"""Stake weights and departures in the port (scenario/weights.py,
`BitSet.weight_sum`, `Identity.weight`, `ArrayRegistry.weights`,
`Config.weights`/`weight_threshold`, the store's weighted score and
`full_weight`, `Handel.mark_departed`) against the JAX package's.

Tolerance: exact. Weight vectors are compared float for float, weight sums
and scores with `==` (both packages run the same numpy dot and the same
float arithmetic), reachability verdicts by outcome and message. Rounds
are compared by their outcome: the gate, the departures every survivor
marked, the churners' exit, and every final's stake against the gate.
"""

import asyncio
import random

import numpy as np
import pytest

from handel_tpu.core import bitset as jbitset
from handel_tpu.core import crypto as jcrypto
from handel_tpu.core import identity as jidentity
from handel_tpu.core import partitioner as jpartitioner
from handel_tpu.core import store as jstore
from handel_tpu.core.config import Config as JConfig
from handel_tpu.core.test_harness import LocalCluster as JLocalCluster
from handel_tpu.models import fake as jfake
from handel_tpu.network.geo import GeoConfig as JGeoConfig
from handel_tpu.scenario import weights as jweights
from handel_tpu.sim import adversary as jadv
from handel_tpu_torch.core import bitset, crypto, identity, partitioner, store
from handel_tpu_torch.core.config import Config
from handel_tpu_torch.core.test_harness import LocalCluster
from handel_tpu_torch.models import fake
from handel_tpu_torch.network.geo import GeoConfig
from handel_tpu_torch.scenario import planets
from handel_tpu_torch.scenario import weights as pweights
from handel_tpu_torch.sim import adversary as padv

PORT = (bitset, crypto, identity, partitioner, store, fake, Config, LocalCluster, GeoConfig)
REF = (jbitset, jcrypto, jidentity, jpartitioner, jstore, jfake, JConfig, JLocalCluster,
       JGeoConfig)


def outcome(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs), None
    except ValueError as e:
        return None, str(e)


# -- weight profiles -------------------------------------------------------


@pytest.mark.parametrize("profile", pweights.PROFILES)
@pytest.mark.parametrize("n", [0, 1, 2, 7, 32, 128, 1000])
@pytest.mark.parametrize("seed", [0, 7, 13])
def test_make_weights_matches_float_for_float(profile, n, seed):
    ours = pweights.make_weights(profile, n, seed=seed)
    assert ours == jweights.make_weights(profile, n, seed=seed)
    assert all(type(v) is float for v in ours)
    if n and profile != "count":
        assert sum(ours) == pytest.approx(float(n))


def test_unknown_profile_is_refused_alike():
    assert pweights.PROFILES == jweights.PROFILES
    assert outcome(pweights.make_weights, "lunar", 8) == \
        outcome(jweights.make_weights, "lunar", 8)
    assert outcome(pweights.make_weights, "lunar", 8)[1]


# -- weight_sum on bitsets ---------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 64, 65, 200, 1000])
def test_weight_sum_on_random_bitsets(n):
    rng = random.Random(n)
    weights = pweights.make_weights("pareto", n, seed=n)
    for density in (0.0, 0.1, 0.5, 1.0):
        for _ in range(5):
            bits = [i for i in range(n) if rng.random() < density]
            ours, theirs = bitset.BitSet(n), jbitset.BitSet(n)
            for i in bits:
                ours.set(i, True)
                theirs.set(i, True)
            got = ours.weight_sum(weights)
            assert got == theirs.weight_sum(weights)
            assert got == theirs.weight_sum(np.asarray(weights))
            assert ours.weight_sum([1.0] * n) == float(ours.cardinality())
    assert bitset.AllOnesBitSet(n).weight_sum(weights) == \
        jbitset.AllOnesBitSet(n).weight_sum(weights)
    assert bitset.BitSet(0).weight_sum([]) == 0.0


def test_registry_weights_match():
    w = pweights.make_weights("split", 9)

    def reg(side):
        ident = side[2]
        return ident.ArrayRegistry(
            [ident.Identity(i, f"n-{i}", side[5].FakePublic(True), weight=w[i])
             for i in range(9)])

    ours, theirs = reg(PORT), reg(REF)
    assert ours.weights().dtype == np.float64
    assert ours.weights().tolist() == theirs.weights().tolist() == w
    assert ours.weights() is ours.weights()  # cached, as the reference's
    assert identity.Identity(0, "a", None).weight == 1.0


# -- the store's weighted scores ---------------------------------------------


def build(side, n: int, node: int, weights):
    bs, cr, ident, part, st, fk = side[:6]
    reg = ident.ArrayRegistry(
        [ident.Identity(i, f"n-{i}", fk.FakePublic(True)) for i in range(n)])
    p = part.BinomialPartitioner(node, reg)
    s = st.SignatureStore(p, bs.BitSet, fk.FakeConstructor(), weights=weights)
    own = bs.BitSet(1)
    own.set(0, True)
    s.store(part.IncomingSig(node, 0, cr.MultiSignature(own, fk.FakeSignature(True)),
                             is_ind=True, mapped_index=0))
    return p, s


def candidates(side, p, rng: random.Random, count: int):
    bs, cr, _, part, _, fk = side[:6]
    out = []
    for _ in range(count):
        lvl = rng.choice(p.levels())
        lo, hi = p.range_level(lvl)
        origin = rng.randrange(lo, hi)
        if rng.random() < 0.4:
            idx, ind = [origin - lo], True
        else:
            idx, ind = sorted(rng.sample(range(hi - lo), rng.randrange(1, hi - lo + 1))), False
        b = bs.BitSet(hi - lo)
        for i in idx:
            b.set(i, True)
        out.append(part.IncomingSig(origin, lvl, cr.MultiSignature(b, fk.FakeSignature(True)),
                                    is_ind=ind, mapped_index=idx[0] if ind else 0))
    return out


@pytest.mark.parametrize("profile", ["count", "linear", "pareto", "split"])
@pytest.mark.parametrize("n, node, seed", [(8, 0, 1), (21, 13, 3), (64, 40, 4)])
def test_weighted_scores_and_full_weight_match_exactly(profile, n, node, seed):
    w = pweights.make_weights(profile, n, seed=seed)
    (po, so), (pt, st_) = build(PORT, n, node, w), build(REF, n, node, w)
    seq_o = candidates(PORT, po, random.Random(seed), 4 * n)
    seq_t = candidates(REF, pt, random.Random(seed), 4 * n)
    for a, b in zip(seq_o, seq_t):
        score = so.evaluate(a)
        assert score == st_.evaluate(b)
        if score > 0:
            so.store(a)
            st_.store(b)
        assert so.full_weight() == st_.full_weight()
        assert so.full_weight(w) == st_.full_weight(w)
        assert so.full_cardinality() == st_.full_cardinality()
    if profile == "count":
        assert so.full_weight() == float(so.full_cardinality())


def test_count_weights_score_as_the_unweighted_store():
    n, node, seed = 32, 5, 9
    (pw, sw), (pc, sc) = build(PORT, n, node, [1.0] * n), build(PORT, n, node, None)
    seq_w = candidates(PORT, pw, random.Random(seed), 100)
    seq_c = candidates(PORT, pc, random.Random(seed), 100)
    for a, b in zip(seq_w, seq_c):
        score = sw.evaluate(a)
        assert score == sc.evaluate(b)
        if score > 0:
            sw.store(a)
            sc.store(b)


# -- reachability with weights -----------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_threshold_reachability_with_weights_and_departures(seed):
    rng = random.Random(seed)
    total = rng.randrange(8, 48)
    counts = {"churner": rng.randrange(0, 4), "invalid_signer": rng.randrange(0, 2)}
    roles = jadv.adversary_roles(counts, total)
    failing = rng.randrange(0, 3)
    w = jweights.make_weights(rng.choice(jweights.PROFILES), total, seed=seed)
    departed = set(rng.sample(range(total), rng.randrange(0, 3)))
    for frac in (0.3, 0.55, 0.8, 0.95):
        kw = dict(weights=w, weight_threshold=frac * sum(w), departed=departed)
        for threshold in (total // 2, total - failing - 2):
            assert outcome(padv.check_threshold_reachable, threshold, total, failing,
                           roles, **kw) == \
                outcome(jadv.check_threshold_reachable, threshold, total, failing, roles, **kw)


def test_geo_weighted_shape_is_reachable():
    """results/geo_weighted.toml's run cut to the card phase's shape (32
    nodes, 3 churners) and to 16 nodes with 2: both packages accept it."""
    for n, k in ((32, 3), (16, 2), (128, 12)):
        w = pweights.make_weights("pareto", n, seed=7)
        roles = padv.adversary_roles({"churner": k}, n)
        threshold = n * 51 // 100 + (1 if n * 51 % 100 else 0)
        kw = dict(weights=w, weight_threshold=0.55 * sum(w))
        assert outcome(padv.check_threshold_reachable, threshold, n, 0, roles, **kw) == \
            outcome(jadv.check_threshold_reachable, threshold, n, 0, roles, **kw) == (None, None)


# -- a weighted, churning round ----------------------------------------------


def weighted_round(side, n: int, churners: int, profile: str, frac: float):
    """One round on the in-process harness: pareto (or other) stake, a gate
    of `frac` of the stake, `churners` nodes leaving after 50 ms on a
    3-region planet (300 ms cross-region RTT, so they leave mid-round)."""
    Cfg, Cluster, Geo = side[6], side[7], side[8]
    w = pweights.make_weights(profile, n, seed=7)
    roles = padv.adversary_roles({"churner": churners}, n)
    threshold = n // 2 + 1
    gate = frac * sum(w)

    def factory(i):
        c = Cfg()
        c.contributions = threshold
        c.weights = w
        c.weight_threshold = gate
        c.rand = random.Random(1 + i)
        return c

    regions, rtt = planets.planet_preset("planet-3region")
    geo = Geo(regions=regions, rtt_ms=rtt, jitter_ms=0.0, seed=7)

    async def go():
        cl = Cluster(n, threshold=threshold, config_factory=factory, adversaries=roles,
                     geo=geo, churn_after_s=0.05)
        cl.start()
        try:
            finals = await cl.wait_complete_success(timeout=60)
        finally:
            cl.stop()
        return cl, finals

    cl, finals = asyncio.run(go())
    hs = cl.handels.values()
    return {
        "gate": {h.weight_threshold for h in hs},
        "departed": {frozenset(h.departed) for h in hs},
        "departedCt": {h.values()["departedCt"] for h in hs},
        "unreachable": {h.values()["thresholdUnreachableCt"] for h in hs},
        "left": sorted((i, a.values()["advLeftCt"]) for i, a in cl.adversaries.items()),
        "honest": sorted(cl.handels),
        "cleared": all(f.bitset.weight_sum(w) >= gate for f in finals.values()),
    }, gate, set(roles)


@pytest.mark.parametrize("n, churners, profile, frac",
                         [(16, 2, "pareto", 0.55), (24, 3, "split", 0.5), (12, 1, "linear", 0.6)])
def test_weighted_churning_round_beside_reference(n, churners, profile, frac):
    ours, gate, churned = weighted_round(PORT, n, churners, profile, frac)
    theirs, jgate, _ = weighted_round(REF, n, churners, profile, frac)
    assert ours == theirs
    assert ours["gate"] == {gate} and gate == jgate
    assert ours["departed"] == {frozenset(churned)}
    assert ours["departedCt"] == {float(churners)}
    assert ours["unreachable"] == {0.0}
    assert ours["left"] == [(i, 1.0) for i in sorted(churned)]
    assert ours["cleared"]


def test_mark_departed_matches_the_reference():
    """Node 0 of 8 holds node 2's signature at level 2 ({2, 3}); node 3
    leaves: the level completes on the departure, 3 leaves the send list,
    its individual signature is dropped at intake, and the count threshold
    (all 8) is re-checked as unreachable, in both packages alike."""
    from handel_tpu.core import handel as jhandel
    from handel_tpu.core import test_harness as jharness
    from handel_tpu_torch.core import handel as phandel
    from handel_tpu_torch.core import test_harness as pharness

    def drive(side, hmod, harness):
        bs, cr, ident, part, _, fk, Cfg = side[:7]
        n = 8
        reg = ident.ArrayRegistry(
            [ident.Identity(i, f"n-{i}", fk.FakePublic(True)) for i in range(n)])
        cfg = Cfg()
        cfg.contributions = n
        out = []

        async def go():
            net = harness.InProcessNetwork(harness.InProcessRouter(), "n-0")
            h = hmod.Handel(net, reg, reg.identity(0), fk.FakeConstructor(), b"m",
                            fk.FakeSignature(True), cfg)
            two = bs.BitSet(2)
            two.set(0, True)
            h.store.store(part.IncomingSig(2, 2, cr.MultiSignature(two, fk.FakeSignature(True)),
                                           is_ind=True, mapped_index=0))
            lvl2 = h.levels[2]
            out.append((lvl2.rcv_completed, lvl2.expected_members()))
            h.mark_departed(3)
            h.mark_departed(3)  # idempotent
            h.mark_departed(0)  # self: ignored
            out.append((sorted(h.departed), sorted(lvl2.departed), lvl2.rcv_completed,
                        lvl2.expected_members()))
            lvl2.set_started()
            out.append([p.id for p in lvl2.select_next_peers(2)])
            one = bs.BitSet(2)
            one.set(1, True)
            h.proc.add(part.IncomingSig(3, 2, cr.MultiSignature(one, fk.FakeSignature(True)),
                                        is_ind=True, mapped_index=1))
            v = h.values()
            out.append((v["departedCt"], v["sigDepartedDropped"], v["thresholdUnreachableCt"]))
            h.stop()

        asyncio.run(go())
        return out

    ours = drive(PORT, phandel, pharness)
    assert ours == drive(REF, jhandel, jharness)
    assert ours == [(False, 2), ([3], [3], True, 1), [2], (1.0, 1.0, 1.0)]


# -- a weighted round on the port's device scheme -----------------------------


def test_weighted_churning_round_on_the_port_device_scheme_cpu():
    """The card test's round (tests/test_torch_cuda.py) on bn254-cuda's CPU
    engine: 4 nodes through one service, the churner gone at once, every
    final verifying on the host oracle and over the stake gate; every
    verdict the engine gave, and its rejection of the forgery sent after
    the round, equal to the host oracle's on the same candidates."""
    from handel_tpu_torch.models.bn254 import BN254Scheme
    from tests.test_torch_cuda import _replayed, _weighted_round_on

    run = _weighted_round_on("cpu", 4, 4)
    assert run.gate == 0.55 * sum(pweights.make_weights("pareto", 4, seed=7))
    assert sorted(run.stakes) == [0, 1, 2] and all(s >= run.gate for s in run.stakes.values())
    assert run.departed == {i: [3] for i in range(3)}
    assert run.values["failoverBatches"] == run.values["deviceRetryCt"] == 0.0
    assert run.values["verifierLaunches"] >= 1 and run.values["verifierCandidates"] > 0
    assert run.b1 == 0  # CPU tensors take the plain multiply
    verdicts = [v for _, v in run.log]
    assert verdicts[-1] == [False] and [True] in verdicts[:-1]
    assert _replayed(run, BN254Scheme().constructor) == verdicts
