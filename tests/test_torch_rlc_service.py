"""The port's RLC engine behind the shared batch verifier, on the CPU: a
forged launch's bisection, which relaunches from `fetch` on the service's
fetching thread, beside the next launch's dispatch on the dispatching
thread (`BatchVerifierService(max_inflight=2)`).

Every launch of the engine must run under its dispatch lock (on the card
also on its verify stream) and no two at once: a launch's plan views a
rotating staging set, so a relaunch outside the lock could rewrite the
buffers a concurrent dispatch is reading. Sessions with different messages
fuse into one launch; verdicts, launches and RLC counters are checked
against the ones known by construction and the reference HostDevice's.
"""

import asyncio
import random
import threading
import time

import pytest
import torch

from handel_tpu import native as nat
from handel_tpu.core.bitset import BitSet
from handel_tpu.models.bn254 import BN254PublicKey, BN254Scheme, BN254Signature, hash_to_g1
from handel_tpu.ops import bn254_ref as jbn
from handel_tpu.service.driver import HostDevice as JHostDevice
from handel_tpu_torch.models.bn254_torch import BN254Device
from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService

torch.set_num_threads(1)

N = 12
C = 4


@pytest.fixture(scope="module")
def registry():
    rng = random.Random(43)
    sks = [rng.randrange(1, 1 << 20) for _ in range(N)]
    pks = [BN254PublicKey(p) for p in nat.g2_mul_batch([jbn.G2_GEN] * N, sks)]
    return sks, pks


def request(sks, msg, idx, forge=False):
    bs = BitSet(N)
    for i in idx:
        bs.set(i, True)
    k = (sum(sks[i] for i in idx) + (1 if forge else 0)) % jbn.R
    return bs, BN254Signature(jbn.g1_mul(hash_to_g1(msg), k))


class LaunchLog:
    """Wraps the engine's two launch bodies, its dispatch_multi (the
    service's entry, which waits for the dispatch lock) and its fetch: every
    launch must find the dispatch lock held, and the log keeps (what, start,
    end) of each call and the most launches that ever ran at once."""

    def __init__(self, engine):
        self.engine = engine
        self.spans: list[tuple[str, float, float]] = []
        self.active = self.peak = 0
        self.unlocked = 0
        self._guard = threading.Lock()
        for attr, what in (("_rlc_combined_launch", "combined"), ("_dispatch_one", "oracle")):
            setattr(engine, attr, self._launch(what, getattr(engine, attr)))
        engine.dispatch_multi = self._span("dispatch", engine.dispatch_multi)
        engine.fetch = self._span("fetch", engine.fetch)

    def _launch(self, what, fn):
        span = self._span(what, fn)

        def call(*args):
            with self._guard:
                self.unlocked += not self.engine._dispatch_lock.locked()
                self.active += 1
                self.peak = max(self.peak, self.active)
            try:
                return span(*args)
            finally:
                with self._guard:
                    self.active -= 1
        return call

    def _span(self, what, fn):
        def call(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                with self._guard:
                    self.spans.append((what, t0, time.perf_counter()))
        return call

    def of(self, what):
        return sorted((a, b) for w, a, b in self.spans if w == what)


def test_forged_launch_bisects_beside_the_next_dispatch(registry):
    """Sessions s0 (m1, honest) and s1 (m2, forged) fuse into launch 1,
    whose combined check fails and bisects into two oracle relaunches on
    the fetching thread; session s2 (m1, two forgeries) arrives once launch
    1 is dispatched, and its launch is dispatched while launch 1's
    bisection runs."""
    sks, pks = registry
    engine = BN254Device(pks, batch_size=C, device="cpu", batch_check="rlc",
                         rlc_rng=random.Random(21))
    log = LaunchLog(engine)
    s0 = [request(sks, b"m1", range(0, 4))]
    s1 = [request(sks, b"m2", range(2, 9), forge=True)]
    s2 = [request(sks, b"m1", [1, 2, 3], forge=True), request(sks, b"m1", range(6, 12), forge=True)]

    async def go():
        svc = BatchVerifierService(engine, fallback=None, max_inflight=2, max_delay_ms=20.0)
        try:
            first = asyncio.gather(svc.verify(b"m1", pks, s0, session="s0"),
                                   svc.verify(b"m2", pks, s1, session="s1"))
            while engine.host_dispatch_launches < 1:  # launch 1 is dispatched
                await asyncio.sleep(0.05)
            second = svc.verify(b"m1", pks, s2, session="s2")
            return await asyncio.gather(first, second), svc.values()
        finally:
            svc.stop()

    (first, second), values = asyncio.run(go())
    assert first == [[True], [False]] and second == [False, False]
    assert log.unlocked == 0 and log.peak == 1
    combined, oracles, fetches = log.of("combined"), log.of("oracle"), log.of("fetch")
    dispatches = log.of("dispatch")
    assert len(combined) == 2 and len(oracles) == 4 and len(fetches) == 2
    assert len(dispatches) == 2
    # launch 2's dispatch and launch 1's bisecting fetch were in flight
    # together (which of them takes the lock first is the scheduler's call)
    assert max(fetches[0][0], dispatches[1][0]) < min(fetches[0][1], dispatches[1][1])
    assert oracles[0][0] < fetches[0][1]
    assert values["verifierLaunches"] == 2.0 and values["verifierCandidates"] == 4.0
    rlc_values = (values["rlcLaunches"], values["bisectionCt"], values["bisectionDepthMax"])
    assert rlc_values == (2.0, 4.0, 1.0)
    assert values["checkMode"] == 1.0
    for key in ("failoverBatches", "deviceRetryCt"):
        assert values[key] == 0.0, key
    assert engine.multi_msg_launches == 1  # launch 1 carried two messages
    # the combined checks' G+1 lanes (G = 2, then 1); as in the reference's
    # engine, its per-candidate oracle launches add no pairing lanes here
    st = engine.rlc_stats
    assert (st.miller_lanes, st.final_exp_lanes) == (3 + 2, 2)

    # the reference's HostDevice on the same items, one launch each
    ref = JHostDevice(BN254Scheme().constructor, batch_check="rlc", rlc_rng=random.Random(4))
    items1 = [(b"m1", pks, *s0[0]), (b"m2", pks, *s1[0])]
    items2 = [(b"m1", pks, *r) for r in s2]
    assert ref.fetch(ref.dispatch_multi(items1)) == [True, False]
    assert ref.fetch(ref.dispatch_multi(items2)) == [False, False]
    assert (ref.rlc_stats.rlc_launches, ref.rlc_stats.bisection_ct) == (2, 4)
