"""The port's BN254 engine under the shared batch verifier, on the CPU.

* Concurrency: a `BatchVerifierService(max_inflight=2)` over a prepared
  `BN254Device(device="cpu")` takes two launches' worth of candidates,
  forged ones among them, while `combine_batch` runs from the event-loop
  thread; the verdicts equal the engine's sequential `batch_verify` and the
  host oracle, the sums equal the host fold.
* Fault injection: an engine whose dispatch raises opens the breaker; with
  a fallback the host verifier answers and `failoverBatches` counts it,
  without one the futures fail and a node's pipeline requeues them.
* Rounds: the port's `LocalCluster` with `verifier_service=`, beside the
  JAX package's harness under the same settings (fake scheme, HostDevice);
  and, in the slow tier, a BN254 round on the CPU engine through one
  service.

Registry and batch sizes are those of tests/test_torch_bn254_device.py.
Tolerance: exact equality of verdicts, points and counters.
"""

from __future__ import annotations

import asyncio
import random

import pytest
import torch

from handel_tpu.core.test_harness import LocalCluster as JLocalCluster
from handel_tpu.core.timeout import InfiniteTimeout as JInfiniteTimeout
from handel_tpu.core.config import Config as JConfig
from handel_tpu.parallel.batch_verifier import BatchVerifierService as JService
from handel_tpu.service.driver import HostDevice as JHostDevice
from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.config import Config
from handel_tpu_torch.core.crypto import verify_multisignature
from handel_tpu_torch.core.test_harness import LocalCluster
from handel_tpu_torch.core.timeout import InfiniteTimeout
from handel_tpu_torch.models.bn254 import BN254PublicKey, BN254Scheme, BN254Signature, hash_to_g1
from handel_tpu_torch.models.bn254_torch import BN254TorchConstructor, BN254TorchScheme
from handel_tpu_torch.models.fake import FakeScheme, FakeSignature
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
from handel_tpu_torch.service.driver import HostDevice
from handel_tpu_torch.utils.breaker import CircuitBreaker

torch.set_num_threads(1)

N = 16
C = 4
MSG = b"service engine"


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(scope="module")
def registry():
    rng = random.Random(41)
    sks = [rng.randrange(1, 1 << 20) for _ in range(N)]
    return sks, [BN254PublicKey(bn.g2_mul(bn.G2_GEN, s)) for s in sks]


@pytest.fixture(scope="module")
def prepared(registry):
    """A constructor whose CPU engine is prepared: every first-use state
    exists before any service starts."""
    _, pks = registry
    cons = BN254TorchConstructor(batch_size=C, device="cpu")
    cons.prepare(pks)
    return cons


def candidate(sks, idx, forge=False, msg=MSG):
    bs = BitSet(N)
    for i in idx:
        bs.set(i, True)
    k = (sum(sks[i] for i in idx) + (1 if forge else 0)) % bn.R
    return bs, BN254Signature(bn.g1_mul(hash_to_g1(msg), k) if k else None)


def two_launches(sks):
    """2C candidates: valid ranges, a forged signature, a wrong message, an
    empty bitset and a range with holes."""
    return [
        candidate(sks, range(2, 10)),
        candidate(sks, range(0, 6), forge=True),
        candidate(sks, [3, 4, 6, 8, 9]),
        candidate(sks, range(5, 9), msg=b"another message"),
        candidate(sks, []),
        candidate(sks, range(9, 16)),
        candidate(sks, [0, 1], forge=True),
        candidate(sks, [15]),
    ]


def host_fold(group):
    acc = None
    for p in group:
        if p is not None:
            acc = p if acc is None else bn.g1_add(acc, p)
    return acc


def test_prepare_builds_first_use_state(prepared):
    """What two threads of a service must not race to build exists once
    prepare returns: the prefix table, the field's device constants, the
    combine classes and H(m) of the warmup message."""
    eng = prepared._device
    assert eng.bank.prefix is not None
    assert eng.curves.F._consts
    assert eng._combine_ready == {2, 4, 8}
    assert b"bn254-device-warmup" in eng._h_cache
    assert eng._verify_stream is None and eng._combine_stream is None  # CPU


def test_service_over_engine_with_concurrent_combines(registry, prepared):
    """Two launches through the service with max_inflight=2 while the loop
    thread runs combines: verdicts equal sequential batch_verify and the
    host oracle; every combine equals the host fold."""
    sks, pks = registry
    eng = prepared._device
    reqs = two_launches(sks)
    rng = random.Random(5)
    pts = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(6)]
    groups = [[rng.choice(pts + [None]) for _ in range(rng.randrange(1, 5))] for _ in range(5)]
    want_sums = [host_fold(g) for g in groups]

    async def go():
        svc = BatchVerifierService(eng, max_delay_ms=1.0, max_inflight=2, fallback=None)
        try:
            verify = asyncio.gather(*(
                svc.verify(MSG, pks, reqs[i:i + 2], session=f"s{i // 2}")
                for i in range(0, len(reqs), 2)
            ))
            await asyncio.sleep(0.05)  # the first dispatch is under way
            sums, overlapped = [], []
            for _ in range(2):
                sums.append(eng.combine_batch(groups))
                overlapped.append(not verify.done())
                await asyncio.sleep(0)
            return [v for part in await verify for v in part], sums, overlapped, svc.values()
        finally:
            svc.stop()

    got, sums, overlapped, values = run(go())
    assert overlapped[0], "the combine did not run while a launch was in flight"
    want = [True, False, True, False, False, True, False, True]
    assert got == want
    assert eng.batch_verify(MSG, reqs) == want
    assert BN254Scheme().constructor.batch_verify(MSG, pks, reqs) == want
    assert sums and all(s == want_sums for s in sums)
    assert values["verifierLaunches"] == 2.0
    assert values["verifierCandidates"] == 8.0
    assert values["failoverBatches"] == values["deviceRetryCt"] == 0.0
    assert values["hostPackLaunches"] >= 2.0


class FailingEngine:
    """An engine wrapper whose dispatch raises on its first `fail` calls."""

    def __init__(self, engine, fail: int):
        self.engine = engine
        self.batch_size = engine.batch_size
        self.fail = fail
        self.calls = 0

    def dispatch(self, msg, reqs):
        self.calls += 1
        if self.calls <= self.fail:
            raise RuntimeError("injected launch fault")
        return self.engine.dispatch(msg, reqs)

    def fetch(self, handle):
        return self.engine.fetch(handle)


def test_breaker_opens_and_host_fallback_answers(registry, prepared):
    sks, pks = registry
    reqs = two_launches(sks)[:C]
    host = BN254Scheme().constructor

    async def go():
        svc = BatchVerifierService(
            FailingEngine(prepared._device, fail=10**6), max_delay_ms=1.0,
            breaker=CircuitBreaker(threshold=2, cooldown_s=600.0), retry_limit=3,
            backoff_base_s=0.001, backoff_cap_s=0.002,
            fallback=lambda msg, r: host.batch_verify(msg, pks, r),
        )
        try:
            return await svc.verify(MSG, pks, reqs), svc.values(), svc.device.calls
        finally:
            svc.stop()

    got, values, calls = run(go())
    assert got == [True, False, True, False]
    assert calls == 2  # the breaker opened at its threshold, before the retry limit
    assert values["breakerState"] == 1.0 and values["breakerOpenCt"] == 1.0
    assert values["deviceRetryCt"] == 1.0
    assert values["failoverBatches"] == 1.0 and values["failoverCandidates"] == 4.0
    assert values["verifierLaunches"] == 0.0


class FlakyHostDevice(HostDevice):
    """A HostDevice whose launches raise on its first `fail` calls."""

    def __init__(self, constructor, fail: int):
        super().__init__(constructor, batch_size=16)
        self.fail = fail
        self.calls = 0

    def dispatch_multi(self, items):
        self.calls += 1
        if self.calls <= self.fail:
            raise RuntimeError("injected launch fault")
        return super().dispatch_multi(items)


def test_no_fallback_fails_futures_and_the_pipeline_requeues():
    """With fallback=None a failed launch fails its futures; each node's
    pipeline requeues the candidates, and the round completes once the
    device answers again."""
    scheme = FakeScheme()
    requeued = []

    async def go():
        svc = BatchVerifierService(
            FlakyHostDevice(scheme.constructor, fail=3),
            max_delay_ms=1.0, fallback=None, retry_limit=0,
            breaker=CircuitBreaker(threshold=100),
        )
        with pytest.raises(RuntimeError, match="device unavailable"):
            await svc.verify(b"m", [], [(BitSet(4), FakeSignature(True))])

        def factory(i):
            c = Config()
            c.verifier = svc.verify
            c.new_timeout = InfiniteTimeout
            c.rand = random.Random(1 + i)
            return c

        cluster = LocalCluster(8, scheme=scheme, config_factory=factory, verifier_service=svc)
        for h in cluster.handels.values():
            real = h.proc._requeue
            h.proc._requeue = lambda batch, _r=real: (requeued.extend(batch), _r(batch))[1]
        cluster.start()
        try:
            res = await cluster.wait_complete_success(timeout=30.0)
        finally:
            cluster.stop()
            svc.stop()
        return res, svc.values(), cluster

    res, values, cluster = run(go())
    assert len(res) == 8 and all(s.cardinality() >= cluster.threshold for s in res.values())
    assert requeued, "no node requeued a candidate after the failed launches"
    assert values["failoverBatches"] == 0.0 and values["deviceRetryCt"] == 0.0
    assert values["verifierLaunches"] > 0


def round_config(cfg_cls, timeout_cls, service, seed):
    def factory(i):
        c = cfg_cls()
        c.verifier = service.verify
        c.new_timeout = timeout_cls
        c.rand = random.Random(seed + i)
        return c
    return factory


@pytest.mark.parametrize("n", [16, 32, 64, 128])
def test_round_through_one_service_beside_reference(n):
    """n nodes of the fake scheme through one service over a HostDevice:
    complete success with fewer launches than nodes, in the port's harness
    and in the JAX package's under the same settings. The service's counts
    depend on when candidates reach its collector; what holds whatever the
    timing is checked on both sides: at most one launch per 4 nodes, the
    fill the launch and candidate counts give, and dedup hits (on the CPU,
    128 nodes give 7 launches, 254 candidates, fill 0.283 and a dedup hit
    rate near 0.917 in both packages)."""
    from handel_tpu.core.test_harness import FakeScheme as JFakeScheme

    seed = 1

    def side(cluster_cls, cfg_cls, timeout_cls, svc_cls, dev_cls, scheme):
        async def go():
            svc = svc_cls(dev_cls(scheme.constructor, batch_size=128), fallback=None)
            cluster = cluster_cls(
                n, scheme=scheme, seed=seed, verifier_service=svc,
                config_factory=round_config(cfg_cls, timeout_cls, svc, seed),
            )
            cluster.start()
            try:
                res = await cluster.wait_complete_success(timeout=60.0)
            finally:
                cluster.stop()
                svc.stop()
            assert cluster.verifier_service is svc
            return res, svc.values(), cluster.threshold

        res, values, threshold = run(go())
        launches, candidates = values["verifierLaunches"], values["verifierCandidates"]
        return {
            "final": sorted(res),
            "at_threshold": all(s.cardinality() >= threshold for s in res.values()),
            "fewer_launches_than_nodes": 0 < launches < n,
            "coalesced": launches <= n // 4,
            "fill_of_counts": values["launchFillRatio"] == candidates / (launches * 128),
            "dedup_hits": values["dedupHits"] >= 1 and values["dedupHitRate"] > 0.5,
            "failovers": values["failoverBatches"],
        }

    ours = side(LocalCluster, Config, InfiniteTimeout, BatchVerifierService, HostDevice,
                FakeScheme())
    theirs = side(JLocalCluster, JConfig, JInfiniteTimeout, JService, JHostDevice,
                  JFakeScheme())
    assert ours == theirs == {
        "final": list(range(n)), "at_threshold": True,
        "fewer_launches_than_nodes": True, "coalesced": True, "fill_of_counts": True,
        "dedup_hits": True, "failovers": 0.0,
    }


@pytest.mark.slow
def test_bn254_round_through_one_service_on_cpu():
    """An 8-node BN254 round on the port's CPU engine, every node verifying
    through one service over the prepared engine: every final signature at
    the threshold and verifying on the host oracle, fewer launches than
    nodes, no failover."""
    scheme = BN254TorchScheme(batch_size=8, device="cpu")
    msg = b"hello world"

    async def go():
        holder = {}

        async def verify(m, pks, reqs):
            return await holder["svc"].verify(m, pks, reqs)

        def factory(i):
            c = Config()
            c.verifier = verify
            c.new_timeout = InfiniteTimeout
            c.rand = random.Random(1 + i)
            return c

        cluster = LocalCluster(8, scheme=scheme, msg=msg, config_factory=factory)
        engine = scheme.constructor.prepare(cluster.registry.public_keys())
        svc = holder["svc"] = cluster.verifier_service = BatchVerifierService(
            engine, fallback=None)
        cluster.start()
        try:
            return cluster, await cluster.wait_complete_success(timeout=1800.0), svc.values()
        finally:
            cluster.stop()
            svc.stop()

    cluster, results, values = run(go())
    assert len(results) == 8
    for sig in results.values():
        assert sig.cardinality() >= cluster.threshold
        assert verify_multisignature(msg, sig, cluster.registry, scheme.constructor)
    assert 0 < values["verifierLaunches"] < 8
    assert values["failoverBatches"] == values["deviceRetryCt"] == 0.0


def test_kernel_launch_counts_hold_across_threads():
    """Under a service the wrappers of B1 and B2 count launches from a worker
    thread and from the event loop at once: with a shortened switch interval
    and more threads than cores, no count and no width is lost."""
    import sys
    import threading

    from handel_tpu_torch.kernels.fp_mont import MontMulKernel
    from handel_tpu_torch.kernels.rns_mont import RnsMulResidentKernel

    threads_n, per_thread = 16, 3000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for kernel in (MontMulKernel(), RnsMulResidentKernel()):
            def work(k=kernel):
                for i in range(per_thread):
                    k._count(128 + i % 7, 16)

            threads = [threading.Thread(target=work) for _ in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
            assert kernel.launches == threads_n * per_thread
            assert sum(kernel.widths.values()) == threads_n * per_thread
            assert len(kernel.widths) == 7
            assert kernel.rows == {16: threads_n * per_thread}
    finally:
        sys.setswitchinterval(old)
