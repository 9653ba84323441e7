"""The port's verifier RPC (handel_tpu_torch/parallel/rpc_verifier.py)
against the JAX package's: the same request and response frames, byte for
byte, and each package's client against the other's server, with a stub
verification service (no device) on loopback.

Tolerance: identical bytes for every frame; identical verdicts, errors and
counters across the four client/server pairings.
"""

import asyncio
import struct
from types import SimpleNamespace

import pytest

from handel_tpu.core.bitset import BitSet as JBitSet
from handel_tpu.models import bn254 as jbn254
from handel_tpu.models import fake as jfake
from handel_tpu.parallel import rpc_verifier as jrpc
from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.models import bn254
from handel_tpu_torch.models import fake
from handel_tpu_torch.parallel import rpc_verifier as prpc

PORT = SimpleNamespace(BitSet=BitSet, fake=fake, bn254=bn254, rpc=prpc)
REF = SimpleNamespace(BitSet=JBitSet, fake=jfake, bn254=jbn254, rpc=jrpc)


class StubService:
    """Echoes bit 0 of each candidate's bitset as its verdict."""

    def __init__(self):
        self.calls = []

    async def verify(self, msg, pubkeys, requests):
        self.calls.append((msg, len(requests)))
        return [bs.get(0) for bs, _ in requests]


class Exploding:
    async def verify(self, msg, pubkeys, requests):
        raise RuntimeError("device on fire")


def fake_requests(pkg, pattern):
    out = []
    for bit in pattern:
        bs = pkg.BitSet(8)
        bs.set(0, bit)
        bs.set(3, True)
        out.append((bs, pkg.fake.FakeSignature(True)))
    return out


def bn254_requests(pkg, n):
    scheme = pkg.bn254.BN254Scheme()
    out = []
    for i in range(n):
        sk, _ = scheme.keygen(i)
        bs = pkg.BitSet(40)
        bs.set(i, True)
        bs.set(39 - i, True)
        out.append((bs, sk.sign(b"m%d" % i)))
    return out


@pytest.mark.parametrize("req_id, msg, pattern", [
    (1, b"m", [True, False, True]), (2**63 + 5, b"", []), (7, b"x" * 300, [False] * 9)])
def test_request_frames_identical_fake(req_id, msg, pattern):
    ours = prpc._pack_request(req_id, msg, fake_requests(PORT, pattern))
    assert ours == jrpc._pack_request(req_id, msg, fake_requests(REF, pattern))
    rid, m, reqs = prpc._unpack_request(ours, fake.FakeConstructor())
    jrid, jm, jreqs = jrpc._unpack_request(ours, jfake.FakeConstructor())
    assert (rid, m) == (jrid, jm) == (req_id, msg)
    assert [(b.marshal(), s.marshal()) for b, s in reqs] == \
        [(b.marshal(), s.marshal()) for b, s in jreqs]


def test_request_frames_identical_bn254():
    ours = prpc._pack_request(3, b"msg", bn254_requests(PORT, 4))
    assert ours == jrpc._pack_request(3, b"msg", bn254_requests(REF, 4))
    _, _, reqs = prpc._unpack_request(ours, bn254.BN254Scheme().constructor)
    assert prpc._pack_request(3, b"msg", reqs) == ours


@pytest.mark.parametrize("body", [
    struct.pack(">QIH", 7, 0, 1),             # one item announced, none sent
    struct.pack(">QI", 9, 50) + b"short",     # message shorter than announced
    struct.pack(">QIH", 4, 0, 1) + struct.pack(">I", 3) + b"\xff\xff\xff"
    + struct.pack(">I", 0),                   # a bitset that does not parse
])
def test_malformed_requests_fail_alike(body):
    def err(mod, cons):
        try:
            mod._unpack_request(body, cons)
        except Exception as e:  # noqa: BLE001 - the server answers any error
            return type(e).__name__
        return None

    assert err(prpc, fake.FakeConstructor()) == err(jrpc, jfake.FakeConstructor()) is not None


async def raw_exchange(port: int, bodies: list[bytes]) -> list[bytes]:
    """Send raw request frames, return the raw response bodies in order."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    out = []
    for body in bodies:
        writer.write(struct.pack(">I", len(body)) + body)
        await writer.drain()
        (n,) = struct.unpack(">I", await asyncio.wait_for(reader.readexactly(4), 5))
        out.append(await asyncio.wait_for(reader.readexactly(n), 5))
    writer.close()
    return out


def responses(pkg, service, bodies):
    async def go():
        server = pkg.rpc.VerifierServer(service, pkg.fake.FakeConstructor(), host="127.0.0.1")
        await server.start()
        try:
            return await raw_exchange(server.port, bodies), server.values()
        finally:
            server.stop()

    return asyncio.run(go())


def test_response_frames_identical():
    bodies = [prpc._pack_request(i + 1, b"m", fake_requests(PORT, p))
              for i, p in enumerate([[True], [False, True, False], []])]
    bodies.append(struct.pack(">QIH", 77, 0, 1))  # malformed: an error response
    ours = responses(PORT, StubService(), bodies)
    assert ours == responses(REF, StubService(), bodies)
    assert struct.unpack_from(">QB", ours[0][-1]) == (77, 1)
    assert ours[1] == {"rpcServedRequests": 3.0, "rpcServedCandidates": 4.0,
                       "rpcServeErrors": 1.0}
    err = responses(PORT, Exploding(), bodies[:1])
    assert err == responses(REF, Exploding(), bodies[:1])
    assert b"device on fire" in err[0][0]


@pytest.mark.parametrize("client, server", [(PORT, REF), (REF, PORT), (PORT, PORT)],
                         ids=["port-client-ref-server", "ref-client-port-server", "port-port"])
def test_client_server_interop(client, server):
    """Either package's client against either package's server: multiplexed
    requests answered, a server-side error raised to the caller without
    dropping the link, and the counters on both ends."""
    async def go():
        svc = StubService()
        srv = server.rpc.VerifierServer(svc, server.fake.FakeConstructor(), host="127.0.0.1")
        await srv.start()
        cli = client.rpc.RPCVerifier(f"127.0.0.1:{srv.port}")
        try:
            outs = await asyncio.gather(
                cli.verify(b"m", None, fake_requests(client, [True, False, True])),
                cli.verify(b"m", None, fake_requests(client, [False, False])),
                cli.verify(b"other", None, fake_requests(client, [True])),
            )
            srv.service = Exploding()
            with pytest.raises(RuntimeError, match="device on fire"):
                await cli.verify(b"m", None, fake_requests(client, [True]))
            srv.service = svc
            outs.append(await cli.verify(b"m", None, fake_requests(client, [True])))
            return outs, sorted(svc.calls), cli.values(), srv.values()
        finally:
            cli.stop()
            srv.stop()

    outs, calls, cvals, svals = asyncio.run(go())
    assert outs == [[True, False, True], [False, False], [True], [True]]
    assert calls == [(b"m", 1), (b"m", 2), (b"m", 3), (b"other", 1)]
    assert cvals == {"rpcSentRequests": 5.0, "rpcSentCandidates": 8.0, "rpcLinkErrors": 0.0}
    assert svals == {"rpcServedRequests": 4.0, "rpcServedCandidates": 7.0, "rpcServeErrors": 1.0}


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_link_loss_fails_inflight_then_reconnects(pkg):
    """A request in flight when the server stops and the link drops fails
    with a ConnectionError; the client's next call reconnects to the
    restarted server on the same port."""
    class Stalling:
        def __init__(self):
            self.gate = asyncio.Event()

        async def verify(self, msg, pubkeys, requests):
            await self.gate.wait()
            return [True] * len(requests)

    async def go():
        srv = pkg.rpc.VerifierServer(Stalling(), pkg.fake.FakeConstructor(), host="127.0.0.1")
        await srv.start()
        cli = pkg.rpc.RPCVerifier(f"127.0.0.1:{srv.port}", retry_delay=0.05)
        task = asyncio.ensure_future(cli.verify(b"m", None, fake_requests(pkg, [True])))
        await asyncio.sleep(0.1)
        port = srv.port
        srv.stop()
        cli._writer.close()  # the link drops
        with pytest.raises(ConnectionError):
            await asyncio.wait_for(task, 5)
        srv = pkg.rpc.VerifierServer(StubService(), pkg.fake.FakeConstructor(),
                                     host="127.0.0.1", port=port)
        await srv.start()
        try:
            return await cli.verify(b"m", None, fake_requests(pkg, [True, False])), cli.values()
        finally:
            cli.stop()
            srv.stop()

    got, vals = asyncio.run(go())
    assert got == [True, False]
    assert vals["rpcLinkErrors"] == 1.0 and vals["rpcSentRequests"] == 2.0


def test_unreachable_server_raises_connection_error():
    async def go():
        cli = prpc.RPCVerifier("127.0.0.1:1", connect_retries=2, retry_delay=0.01)
        with pytest.raises(ConnectionError, match="unreachable"):
            await cli.verify(b"m", None, fake_requests(PORT, [True]))

    asyncio.run(go())
