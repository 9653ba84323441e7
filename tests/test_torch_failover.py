"""Two rules of the port's robustness, each with an injected fault.

* No host failover on a card path (ROADMAP §C deviation 1): an engine
  error, the lazy prepare's included, raises out of the constructor's
  `batch_verify` and `device_combine` (`BN254TorchConstructor`, inherited
  by `BLS12381TorchConstructor`). The JAX package's constructor-level
  failover (6e) is not ported; failover stays with the service layer
  (`BatchVerifierService(breaker=..., fallback=...)`).
* C3 (ROADMAP §C): a send that fires after its network stopped, as a
  GeoNetwork's or a ChaosNetwork's delayed send does, is dropped: it raises
  nothing and prints nothing; and `results/geo_weighted.toml` runs whole
  through the port's CLI with clean stderr.

Tolerance: exact (verdicts, call counts, stderr bytes).
"""

import asyncio
import csv
import os
import subprocess
import sys
from pathlib import Path

import pytest

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.identity import Identity
from handel_tpu_torch.core.net import Packet
from handel_tpu_torch.models.bls12_381 import BLS12381Scheme
from handel_tpu_torch.models.bls12_381_torch import BLS12381TorchConstructor
from handel_tpu_torch.models.bn254 import BN254Scheme
from handel_tpu_torch.models.bn254_torch import BN254TorchConstructor
from handel_tpu_torch.network.chaos import ChaosConfig, ChaosNetwork
from handel_tpu_torch.network.geo import GeoConfig, GeoNetwork
from handel_tpu_torch.network.udp import UDPNetwork
from handel_tpu_torch.sim.platform import free_ports

ROOT = Path(__file__).resolve().parents[1]
MSG = b"failover"


class FailingEngine:
    """An engine whose launches raise, as a lost card's would."""

    def __init__(self, n: int, error=RuntimeError("CUDA error: device lost")):
        self.n = n
        self.error = error
        self.calls = 0

    def batch_verify(self, msg, requests):
        self.calls += 1
        raise self.error

    def combine_batch(self, groups, compiled_only=False):
        self.calls += 1
        raise self.error


def requests(scheme, n: int = 3):
    """n keys; a valid aggregate over all, a forged one, and one signer."""
    keys = [scheme.keygen(i) for i in range(n)]
    pks = [pk for _, pk in keys]

    def cand(idx, msg=MSG):
        bs = BitSet(n)
        sig = None
        for i in idx:
            bs.set(i, True)
            s = keys[i][0].sign(msg)
            sig = s if sig is None else sig.combine(s)
        return bs, sig

    return pks, [cand(range(n)), cand([0, 1], msg=b"other"), cand([2])]


def with_engine(cons, pks, engine):
    """Seat `engine` as the constructor's prepared device for `pks`."""
    cons._device = engine
    cons._device_for = id(pks)
    cons._reg_list = pks
    cons._reg_keys = [pk.point for pk in pks]
    return cons


def constructor_of(family):
    return ((BN254Scheme(), BN254TorchConstructor) if family == "bn254"
            else (BLS12381Scheme(), BLS12381TorchConstructor))


@pytest.mark.parametrize("family", ["bn254", "bls12_381"])
def test_failover_is_off_by_default_and_raises(family):
    scheme, cls = constructor_of(family)
    pks, reqs = requests(scheme)
    cons = with_engine(cls(batch_size=4, device="cpu", warmup=False), pks, FailingEngine(3))
    assert not hasattr(cons, "host_fallback") and not hasattr(cons, "breaker")
    for _ in range(5):  # no breaker opens: every call reaches the engine
        with pytest.raises(RuntimeError, match="device lost"):
            cons.batch_verify(MSG, pks, reqs)
        with pytest.raises(RuntimeError, match="device lost"):
            cons.device_combine([[reqs[2][1]] * 2])
    assert cons._device.calls == 10


@pytest.mark.parametrize("family", ["bn254", "bls12_381"])
def test_a_failing_prepare_raises(family):
    """The lazy prepare (the registry's upload) fails as a lost card's
    would: the batch raises, and a combine before any device exists
    declines without forcing the upload."""
    scheme, cls = constructor_of(family)
    pks, reqs = requests(scheme)
    cons = cls(batch_size=4, device="cpu", warmup=False)
    prepares = []

    def prepare(pubkeys):
        prepares.append(len(pubkeys))
        raise RuntimeError("CUDA error: out of memory")

    cons.prepare = prepare
    assert cons.device_combine([[reqs[2][1]] * 2]) is None and prepares == []
    for _ in range(3):
        with pytest.raises(RuntimeError, match="out of memory"):
            cons.batch_verify(MSG, pks, reqs)
    assert prepares == [3, 3, 3] and cons._device is None


# -- C3: a send after stop() ---------------------------------------------------


def test_a_send_after_stop_is_dropped_silently(capfd):
    """A GeoNetwork over UDP stops with delayed sends still scheduled; when
    they fire, they are dropped: no exception in the loop's callbacks, no
    line on stdout or stderr."""
    port_a, port_b = free_ports(2)
    ident_b = Identity(1, f"127.0.0.1:{port_b}", None)
    geo = GeoConfig(regions=("a", "b"), rtt_ms=((0.0, 60.0), (60.0, 0.0)), seed=7,
                    node_id=0)
    errors = []

    async def go():
        loop = asyncio.get_running_loop()
        loop.set_exception_handler(lambda _loop, ctx: errors.append(ctx))
        inner = UDPNetwork(f"127.0.0.1:{port_a}")
        net = GeoNetwork(inner, geo)
        await net.start()
        packet = Packet(origin=0, level=1, multisig=b"\x00" * 8)
        net.send([ident_b], packet)  # delayed 30 ms by the planet
        assert net.geo_delayed == 1 and inner.sent == 0
        net.stop()
        await asyncio.sleep(0.1)  # the delayed send fires after the stop
        inner.send([ident_b], packet)  # and a direct one
        return inner

    inner = asyncio.run(go())
    assert errors == []
    assert inner.sent == 0
    out, err = capfd.readouterr()
    assert out == "" and err == ""


def test_a_chaos_delayed_send_after_stop_is_dropped_silently(capfd):
    """The same over a ChaosNetwork whose every send is delayed: the
    delayed sends that fire after stop() raise nothing and print nothing."""
    port_a, port_b = free_ports(2)
    ident_b = Identity(1, f"127.0.0.1:{port_b}", None)
    errors = []

    async def go():
        loop = asyncio.get_running_loop()
        loop.set_exception_handler(lambda _loop, ctx: errors.append(ctx))
        inner = UDPNetwork(f"127.0.0.1:{port_a}")
        net = ChaosNetwork(inner, ChaosConfig(delay_rate=1.0, delay_ms=30.0, seed=7))
        await net.start()
        packet = Packet(origin=0, level=1, multisig=b"\x00" * 8)
        net.send([ident_b, ident_b], packet)
        assert net.delayed == 2 and inner.sent == 0
        net.stop()
        await asyncio.sleep(0.1)
        return inner

    inner = asyncio.run(go())
    assert errors == [] and inner.sent == 0
    out, err = capfd.readouterr()
    assert out == "" and err == ""


def test_geo_weighted_runs_whole_through_the_cli_with_clean_stderr(tmp_path):
    """results/geo_weighted.toml as it is (128 nodes in one process, the fake
    scheme, pareto stake, 12 churners, the 5-region planet): exit 0, the
    node's stderr empty, departures and geo delays on the CSV."""
    env = dict(os.environ, HANDEL_TORCH_DEVICE="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "handel_tpu_torch.sim", "--config",
         str(ROOT / "results" / "geo_weighted.toml"), "--workdir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "run 0: success" in out.stdout
    assert (tmp_path / "node_0_0.err").read_text() == ""
    assert "node process finished OK" in (tmp_path / "node_0_0.out").read_text()
    with open(tmp_path / "results_0.csv") as f:
        header, row = list(csv.reader(f))[:2]
    col = dict(zip(header, map(float, row)))
    assert col["sigs_departedCt_min"] >= 11  # a churner does not count itself
    assert col["sigs_thresholdUnreachableCt_max"] == 0
    assert col["net_geoDelayed_sum"] > 0 and col["net_delayMs_n"] > 0


# -- C4: a serving process's exit and its clients' records ---------------------


class EchoService:
    async def verify(self, msg, pubkeys, requests):
        return [True] * len(requests)


def one_request():
    from handel_tpu_torch.models.fake import FakeSignature

    bs = BitSet(4)
    bs.set(1, True)
    return [(bs, FakeSignature(True))]


def test_an_idle_link_closed_by_its_server_counts_a_link_error_in_both():
    """The fault's mechanism, as in the JAX package's client: a link its
    server closes counts a link error although nothing is in flight, so a
    serving process that exits before its clients have recorded puts an
    error on a clean run's record."""
    from handel_tpu.core.bitset import BitSet as JBitSet
    from handel_tpu.models import fake as jfake
    from handel_tpu.parallel import rpc_verifier as jrpc
    from handel_tpu_torch.models import fake as pfake
    from handel_tpu_torch.parallel import rpc_verifier as prpc

    def run(rpc, fk, bitset):
        async def go():
            srv = rpc.VerifierServer(EchoService(), fk.FakeConstructor(), host="127.0.0.1")
            links = []
            handle = srv._handle

            async def keep(reader, writer):
                links.append(writer)
                await handle(reader, writer)

            srv._handle = keep
            await srv.start()
            cli = rpc.RPCVerifier(f"127.0.0.1:{srv.port}")
            bs = bitset(4)
            bs.set(1, True)
            try:
                got = await cli.verify(b"m", None, [(bs, fk.FakeSignature(True))])
                links[0].close()  # what the serving process's exit does
                await asyncio.sleep(0.2)
                return got, cli.values()
            finally:
                cli.stop()
                srv.stop()

        return asyncio.run(go())

    ours = run(prpc, pfake, BitSet)
    assert ours == run(jrpc, jfake, JBitSet)
    assert ours == ([True], {"rpcSentRequests": 1.0, "rpcSentCandidates": 1.0,
                             "rpcLinkErrors": 1.0})


def test_a_serving_process_waits_for_its_clients_to_close_their_links():
    """The repair: after the END barrier the serving node stops accepting
    links and waits for its clients to close theirs (each closes right
    after its record), at most RPC_CLIENTS_CLOSE_S; the client's record
    reads no link error."""
    from handel_tpu_torch.parallel.rpc_verifier import RPCVerifier, VerifierServer
    from handel_tpu_torch.models.fake import FakeConstructor
    from handel_tpu_torch.sim.node import RPC_CLIENTS_CLOSE_S

    async def go():
        srv = VerifierServer(EchoService(), FakeConstructor(), host="127.0.0.1")
        await srv.start()
        assert await srv.wait_clients_closed(0.01)  # nobody connected yet
        clients = [RPCVerifier(f"127.0.0.1:{srv.port}") for _ in range(2)]
        for cli in clients:
            assert await cli.verify(b"m", None, one_request()) == [True]
        srv.stop()
        waiter = asyncio.ensure_future(srv.wait_clients_closed(RPC_CLIENTS_CLOSE_S))
        await asyncio.sleep(0.2)
        pending = not waiter.done()
        records = [cli.values()["rpcLinkErrors"] for cli in clients]
        clients[0].stop()
        await asyncio.sleep(0.2)
        one_left = not waiter.done()
        # a client that never closes holds the wait to its bound, no longer
        timed_out = not await srv.wait_clients_closed(0.2)
        clients[1].stop()
        return pending, records, one_left, timed_out, await waiter, srv._open_links

    assert asyncio.run(go()) == (True, [0.0, 0.0], True, True, True, 0)
