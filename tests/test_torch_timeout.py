"""The port's swarm pieces of core/ (the timer wheel, `WheelTimeout`, the
windowed store, `Handel.start(periodic=False)`, and peer accounting
turned off by a `new_scorer` that returns None where the JAX package has
`penalize_peers = False`) against the JAX package's. The port leaves out
the simulated verify sleep: its sim params refuse it.

Tolerance: exact. The wheels run on a virtual clock, so the same seeded
schedule/cancel sequence gives the same fire order, ticks and counters in
both packages; the windowed stores get the same seeded insertions and
retirements and must give the same bests, scores, bytes and counters; the
16-node wheel-driven rounds run on the virtual clock too and must give the
same finals and the same per-node counters (all but `sigCheckingTime`,
the host's wall time).
"""

import asyncio
import random

import pytest

from handel_tpu.core import bitset as jbitset
from handel_tpu.core import config as jconfig
from handel_tpu.core import crypto as jcrypto
from handel_tpu.core import handel as jhandel
from handel_tpu.core import identity as jidentity
from handel_tpu.core import partitioner as jpartitioner
from handel_tpu.core import processing as jprocessing
from handel_tpu.core import store as jstore
from handel_tpu.core import test_harness as jharness
from handel_tpu.core import timeout as jtimeout
from handel_tpu.models import fake as jfake
from handel_tpu.sim import config as rsimconfig
from handel_tpu_torch.core import bitset, config, crypto, handel, identity, partitioner
from handel_tpu_torch.core import processing, store, test_harness, timeout
from handel_tpu_torch.models import fake
from handel_tpu_torch.sim import config as psimconfig

PORT = dict(bitset=bitset, config=config, crypto=crypto, handel=handel,
            identity=identity, partitioner=partitioner, processing=processing,
            store=store, harness=test_harness, timeout=timeout, fake=fake)
# peer accounting off: the port's vnodes pass a `new_scorer` that returns
# None, the JAX package's set `penalize_peers = False`
NO_SCORER = {config: {"new_scorer": lambda h: None}, jconfig: {"penalize_peers": False}}
REF = dict(bitset=jbitset, config=jconfig, crypto=jcrypto, handel=jhandel,
           identity=jidentity, partitioner=jpartitioner, processing=jprocessing,
           store=jstore, harness=jharness, timeout=jtimeout, fake=jfake)


class VirtualClockLoop(asyncio.SelectorEventLoop):
    """An event loop whose clock stands still while callbacks are ready and
    jumps to the next live timer when none is: the wheel's ticks and every
    callback's place in them then follow the schedule, not the host."""

    def __init__(self):
        super().__init__()
        self._virtual_now = 0.0

    def time(self) -> float:
        return self._virtual_now

    def _run_once(self) -> None:
        if not self._ready:
            due = [h.when() for h in self._scheduled if not h.cancelled()]
            if due:
                self._virtual_now = max(self._virtual_now, min(due))
        super()._run_once()


def run_on_virtual_clock(coro):
    with asyncio.Runner(loop_factory=VirtualClockLoop) as runner:
        return runner.run(coro)


# -- the timer wheel -------------------------------------------------------


async def drive_wheel(tm, seed: int, tick_s: float, horizon_s: float):
    """A seeded schedule/cancel sequence on one package's wheel: one-shots
    and periodics scheduled up front and from inside callbacks, some
    cancelled before or after their first fire, one callback that raises.
    Returns the fire log (tick, label) and the wheel's counters."""
    rng = random.Random(seed)
    loop = asyncio.get_running_loop()
    wheel = tm.TimerWheel(tick_s=tick_s)
    wheel.YIELD_EVERY = 3  # yield inside long buckets, as a big swarm does
    log = []
    handles = {}

    def cb(label):
        def fire():
            log.append((round(loop.time() / tick_s), wheel._tick, label))
            r = rng.random()
            if r < 0.15:
                name = f"{label}>{len(log)}"
                handles[name] = wheel.schedule(rng.uniform(0.0, 0.2), cb(name))
            elif r < 0.25 and handles:
                handles[rng.choice(sorted(handles))].cancel()
            elif r < 0.28:
                raise RuntimeError("a broken vnode")
        return fire

    wheel.start()
    for i in range(40):
        kind = rng.random()
        if kind < 0.6:
            handles[f"o{i}"] = wheel.schedule(rng.uniform(0.0, 0.3), cb(f"o{i}"))
        else:
            handles[f"p{i}"] = wheel.schedule_periodic(
                rng.uniform(0.005, 0.1), cb(f"p{i}"),
                phase_s=rng.choice([0.0, rng.uniform(0.0, 0.1)]),
            )
    for name in rng.sample(sorted(handles), 8):
        handles[name].cancel()
    await asyncio.sleep(horizon_s)
    values = wheel.values()
    wheel.stop()
    return log, values, wheel.values()


@pytest.mark.parametrize("seed, tick_s", [(0, 0.010), (1, 0.010), (2, 0.005), (3, 0.020)])
def test_timer_wheel_fire_order_and_counters_match(seed, tick_s):
    ours = run_on_virtual_clock(drive_wheel(timeout, seed, tick_s, 0.5))
    theirs = run_on_virtual_clock(drive_wheel(jtimeout, seed, tick_s, 0.5))
    assert ours == theirs
    log, values, stopped = ours
    assert len(log) > 40
    assert values["wheelCancelledCt"] > 0
    assert stopped["wheelPendingSize"] == 0.0


def test_timer_wheel_rejects_a_zero_tick():
    for tm in (timeout, jtimeout):
        with pytest.raises(ValueError, match="tick_s must be > 0"):
            tm.TimerWheel(tick_s=0)


class LevelLog:
    def __init__(self, loop):
        self.loop = loop
        self.started = []

    def start_level(self, lvl):
        self.started.append((self.loop.time(), lvl))


@pytest.mark.parametrize("stop_after_s", [None, 0.12])
def test_wheel_timeout_starts_levels_like_the_reference(stop_after_s):
    async def go(tm):
        loop = asyncio.get_running_loop()
        wheel = tm.TimerWheel(tick_s=0.01)
        wheel.start()
        h = LevelLog(loop)
        t = tm.WheelTimeout.factory(wheel, 0.05)(h, [1, 2, 3, 4, 5])
        t.start()
        if stop_after_s is not None:
            await asyncio.sleep(stop_after_s)
            t.stop()
        await asyncio.sleep(0.5)
        wheel.stop()
        return h.started, wheel.values()

    ours = run_on_virtual_clock(go(timeout))
    assert ours == run_on_virtual_clock(go(jtimeout))
    started = [lvl for _, lvl in ours[0]]
    assert started == ([1, 2, 3, 4, 5] if stop_after_s is None else [1, 2, 3])


# -- the windowed store ----------------------------------------------------


def build_store(side, n: int, node: int):
    reg = side["identity"].ArrayRegistry(
        [side["identity"].Identity(i, f"n-{i}", side["fake"].FakePublic(True))
         for i in range(n)])
    p = side["partitioner"].BinomialPartitioner(node, reg)
    s = side["store"].WindowedSignatureStore(p, side["bitset"].BitSet,
                                             side["fake"].FakeConstructor())
    own = side["bitset"].BitSet(1)
    own.set(0, True)
    s.store(side["partitioner"].IncomingSig(
        node, 0, side["crypto"].MultiSignature(own, side["fake"].FakeSignature(True)),
        is_ind=True, mapped_index=0))
    return p, s


def seeded_incoming(side, p, rng: random.Random, count: int):
    """`count` seeded candidates over the node's levels, a third of them
    complete aggregates (so levels become retirable)."""
    out = []
    levels = p.levels()
    for _ in range(count):
        lvl = rng.choice(levels)
        lo, hi = p.range_level(lvl)
        size = hi - lo
        origin = rng.randrange(lo, hi)
        r = rng.random()
        if r < 0.35:
            idx, ind = [origin - lo], True
        elif r < 0.65:
            idx, ind = list(range(size)), False
        else:
            idx, ind = sorted(rng.sample(range(size), rng.randrange(1, size + 1))), False
        b = side["bitset"].BitSet(size)
        for i in idx:
            b.set(i, True)
        out.append(side["partitioner"].IncomingSig(
            origin, lvl, side["crypto"].MultiSignature(b, side["fake"].FakeSignature(True)),
            is_ind=ind, mapped_index=idx[0] if ind else 0))
    return out


def store_snapshot(s, p):
    full = s.full_signature()
    return (
        {lvl: (type(ms.bitset).__name__, ms.marshal()) for lvl, ms in s.best_by_level.items()},
        [None if s.combined(lvl) is None else s.combined(lvl).marshal()
         for lvl in range(p.max_level())],
        None if full is None else full.marshal(),
        s.full_cardinality(), s.highest, s.values(), sorted(s.retired),
        sorted(s.indiv_verified), sorted(s.individual_sigs),
    )


@pytest.mark.parametrize("n, node, seed", [(8, 0, 1), (16, 5, 2), (21, 13, 3), (64, 40, 4)])
def test_windowed_store_bests_scores_and_retires_match(n, node, seed):
    (po, so), (pt, st) = build_store(PORT, n, node), build_store(REF, n, node)
    seq_o = seeded_incoming(PORT, po, random.Random(seed), 6 * n)
    seq_t = seeded_incoming(REF, pt, random.Random(seed), 6 * n)
    rng = random.Random(seed + 100)
    for i, (a, b) in enumerate(zip(seq_o, seq_t)):
        score = so.evaluate(a)
        assert score == st.evaluate(b)
        if score > 0:  # as if verified
            ra, rb = so.store(a), st.store(b)
            assert (ra is None) == (rb is None)
            if ra is not None:
                assert ra.marshal() == rb.marshal()
        if rng.random() < 0.1:
            # retire a level as Handel does at receive completion, whether
            # or not its best is complete (idempotent on a retired one)
            lvl = rng.choice(po.levels())
            so.retire_level(lvl)
            st.retire_level(lvl)
        assert store_snapshot(so, po) == store_snapshot(st, pt), i
    values = so.values()
    assert values["retiredLevelCt"] > 0
    assert values["staleRetiredCt"] > 0
    # a complete best is compacted to the all-ones bitset, which marshals
    # to the same bytes as the dense one it replaced
    assert any(kind == "AllOnesBitSet" for kind, _ in store_snapshot(so, po)[0].values())


# -- a round under one wheel ----------------------------------------------


async def wheel_round(side, n: int, threshold: int):
    """n nodes on the in-process router, each started with periodic=False:
    ONE wheel drives their level starts (WheelTimeout) and their gossip
    rounds (`periodic_update`), every store windowed, no peer scorer."""
    reg = side["identity"].ArrayRegistry(
        [side["identity"].Identity(i, f"w-{i}", side["fake"].FakePublic(True))
         for i in range(n)])
    router = side["harness"].InProcessRouter()
    wheel = side["timeout"].TimerWheel(tick_s=0.01)
    wheel.start()
    shared_rand = random.Random(0)
    msg = b"wheel round"
    nodes = []
    for i in range(n):
        cfg = side["config"].Config(
            contributions=threshold, update_period=0.05, level_timeout=0.05,
            fast_path=3, disable_shuffling=True, **NO_SCORER[side["config"]],
            rand=shared_rand, new_store=side["store"].WindowedSignatureStore,
            new_timeout=side["timeout"].WheelTimeout.factory(wheel, 0.05),
        )
        net = side["harness"].InProcessNetwork(router, f"w-{i}")
        nodes.append(side["handel"].Handel(
            net, reg, reg.identity(i), side["fake"].FakeConstructor(), msg,
            side["fake"].FakeSecret(i).sign(msg), cfg))
    handles = []
    for i, h in enumerate(nodes):
        h.start(periodic=False)
        handles.append(wheel.schedule_periodic(0.05, h.periodic_update, phase_s=i * 0.003))
    finals = await asyncio.wait_for(
        asyncio.gather(*(h.final_signatures.get() for h in nodes)), 30.0)
    tasks = sum(1 for h in nodes if h._periodic_task is not None)
    for hd in handles:
        hd.cancel()
    for h in nodes:
        h.stop()
    wheel.stop()
    return (
        [f.marshal() for f in finals],
        # every counter but the host's wall time spent checking
        [{k: v for k, v in h.values().items() if k != "sigCheckingTime"} for h in nodes],
        [sorted(h.store.retired) for h in nodes],
        [h.scorer for h in nodes],
        tasks,
        wheel.values(),
    )


def test_sixteen_node_round_under_one_wheel_completes_in_both():
    ours = run_on_virtual_clock(wheel_round(PORT, 16, 9))
    theirs = run_on_virtual_clock(wheel_round(REF, 16, 9))
    finals, values, retired, scorers, tasks, wheel_values = ours
    assert len(finals) == 16
    assert tasks == 0  # no per-node updater task: the wheel drives them
    assert scorers == [None] * 16
    assert all(retired)  # every node retired at least one level
    assert not any("peerBannedSkips" in v for v in values)
    assert wheel_values["wheelFiredCt"] > 0
    # the same round, packet for packet: same finals, same counters
    assert finals == theirs[0]
    assert retired == theirs[2]
    assert values == theirs[1]
    assert wheel_values == theirs[5]


# -- the Config knobs ------------------------------------------------------


def test_sim_params_build_the_reference_config_and_refuse_the_sleep():
    ours = psimconfig.HandelParams().to_config(3, 1)
    theirs = rsimconfig.HandelParams().to_config(3, 1)
    for key in ("update_period", "update_count", "fast_path", "level_timeout",
                "contributions", "new_store", "new_scorer", "disable_shuffling"):
        assert getattr(ours, key) == getattr(theirs, key), key
    assert theirs.penalize_peers is True and ours.new_scorer is None
    assert rsimconfig.HandelParams(unsafe_sleep_verify_ms=5).to_config(3, 1) \
        .unsafe_sleep_on_verify_ms == 5
    with pytest.raises(NotImplementedError, match="ROADMAP §C, left out"):
        psimconfig.HandelParams(unsafe_sleep_verify_ms=5).to_config(3, 1)
    assert not hasattr(ours, "unsafe_sleep_on_verify_ms")
    for mod in (psimconfig, rsimconfig):
        with pytest.raises(ValueError, match="unknown evaluator"):
            mod.HandelParams(evaluator="bogus").to_config(3, 1)


@pytest.mark.parametrize("accounting", ["on", "off"])
def test_a_none_scorer_matches_the_reference_penalize_switch(accounting):
    """A 4-node round with one forging node (its own signature invalid):
    the port's default scorer counts it as the reference's default does,
    and a `new_scorer` that returns None keeps no accounting, as the
    reference's `penalize_peers = False`: the same finals and the same
    counters in both packages."""
    async def go(side):
        reg = side["identity"].ArrayRegistry(
            [side["identity"].Identity(i, f"s-{i}", side["fake"].FakePublic(True))
             for i in range(4)])
        router = side["harness"].InProcessRouter()
        nodes = []
        for i in range(4):
            knobs = NO_SCORER[side["config"]] if accounting == "off" else {}
            cfg = side["config"].Config(contributions=3, rand=random.Random(i), **knobs)
            own = side["fake"].FakeSignature(i != 3)
            nodes.append(side["handel"].Handel(
                side["harness"].InProcessNetwork(router, f"s-{i}"), reg, reg.identity(i),
                side["fake"].FakeConstructor(), b"m", own, cfg))
        for h in nodes:
            h.start()
        finals = await asyncio.wait_for(
            asyncio.gather(*(h.final_signatures.get() for h in nodes[:3])), 30.0)
        for h in nodes:
            h.stop()
        return ([f.cardinality() for f in finals],
                [h.scorer is None for h in nodes],
                [{k: v for k, v in h.values().items() if k != "sigCheckingTime"}
                 for h in nodes])

    ours = run_on_virtual_clock(go(PORT))
    assert ours == run_on_virtual_clock(go(REF))
    assert all(c >= 3 for c in ours[0])
    assert ours[1] == [accounting == "off"] * 4
    assert all(("peerBannedSkips" in v) == (accounting == "on") for v in ours[2])
