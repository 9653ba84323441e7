"""The port's TLS session transport (handel_tpu_torch/network/quic.py)
against the JAX package's (handel_tpu/network/quic.py).

A port endpoint and a reference endpoint exchange seeded packets both ways
over real localhost TLS sessions: each side decodes the other's packets to
the same bytes it was sent (exact), session reuse keeps one dial per peer,
and both sides count the same packets. The session manager's dedup of
concurrent dials behaves alike. Where `cryptography` is missing (as on the
card's machine), building an endpoint raises an ImportError naming it and
nothing imports it before that.
"""

import asyncio
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from handel_tpu.core.identity import Identity as RIdentity
from handel_tpu.core.net import Packet as RPacket
from handel_tpu.network import quic as rquic
from handel_tpu_torch.core.identity import Identity as PIdentity
from handel_tpu_torch.core.net import Packet as PPacket
from handel_tpu_torch.network import quic as pquic
from handel_tpu_torch.sim.platform import free_ports

ROOT = Path(__file__).resolve().parents[1]


class Inbox:
    def __init__(self):
        self.packets: asyncio.Queue = asyncio.Queue()

    def new_packet(self, packet):
        self.packets.put_nowait(packet)


def packet_fields(seed: int, count: int = 5) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [
        dict(origin=int(rng.integers(0, 1 << 16)), level=int(rng.integers(0, 16)),
             multisig=rng.integers(0, 256, int(rng.integers(1, 200)), dtype=np.uint8).tobytes(),
             individual_sig=(rng.integers(0, 256, 64, dtype=np.uint8).tobytes() if k % 2 else None))
        for k in range(count)
    ]


SIDES = {
    "port": (pquic.QUICNetwork, PIdentity, PPacket),
    "ref": (rquic.QUICNetwork, RIdentity, RPacket),
}


@pytest.mark.parametrize("sender, receiver", [("port", "ref"), ("ref", "port")])
def test_port_and_reference_exchange_both_ways_over_tls(sender, receiver):
    """`sender` sends seeded packets to `receiver` and gets a reply for
    each: every packet arrives as the bytes it was sent, over one session
    a direction."""
    s_net, s_id, s_pkt = SIDES[sender]
    r_net, r_id, r_pkt = SIDES[receiver]
    fields = packet_fields(11)

    async def go():
        ps, pr = free_ports(2)
        a, b = s_net(f"127.0.0.1:{ps}"), r_net(f"127.0.0.1:{pr}")
        ia, ib = Inbox(), Inbox()
        a.register_listener(ia)
        b.register_listener(ib)
        await a.start()
        await b.start()
        try:
            for f in fields:
                a.send([s_id(1, f"127.0.0.1:{pr}", None)], s_pkt(**f))
                got = await asyncio.wait_for(ib.packets.get(), 10)
                assert got.encode() == r_pkt(**f).encode() == s_pkt(**f).encode()
                b.send([r_id(0, f"127.0.0.1:{ps}", None)], r_pkt(**f))
                back = await asyncio.wait_for(ia.packets.get(), 10)
                assert back.encode() == s_pkt(**f).encode()
            return a.values(), b.values(), len(a.sessions._sessions), len(b.sessions._sessions)
        finally:
            a.stop()
            b.stop()

    va, vb, sa, sb = asyncio.run(go())
    n = float(len(fields))
    assert va["sentPackets"] == vb["sentPackets"] == va["rcvdPackets"] == vb["rcvdPackets"] == n
    assert sa == sb == 1


def test_session_manager_dedups_concurrent_dials_alike():
    """Eight concurrent sends to one peer: one dial in both packages, every
    caller handed the same session; a failed dial is not cached."""

    class Writer:
        def is_closing(self):
            return False

        def close(self):
            pass

    def run(mod):
        dials = []

        async def dialer(addr):
            dials.append(addr)
            await asyncio.sleep(0.02)
            if addr == "peer:bad":
                raise OSError("refused")
            return mod.Session(Writer())

        async def go():
            mgr = mod.SessionManager(dialer)
            got = await asyncio.gather(*(mgr.session("peer:1") for _ in range(8)))
            for _ in range(2):
                with pytest.raises(OSError):
                    await mgr.session("peer:bad")
            return all(s is got[0] for s in got)

        return asyncio.run(go()), dials

    assert run(pquic) == run(rquic) == (True, ["peer:1", "peer:bad", "peer:bad"])


def test_insecure_test_config_matches():
    import ssl

    for mod in (pquic, rquic):
        server_ctx, client_ctx = mod.new_insecure_test_config()
        assert server_ctx.protocol == ssl.PROTOCOL_TLS_SERVER
        assert client_ctx.verify_mode == ssl.CERT_NONE and not client_ctx.check_hostname


WITHOUT_CRYPTOGRAPHY = r"""
import sys
sys.modules["cryptography"] = None  # `import cryptography` now raises
from handel_tpu_torch.network.quic import QUICNetwork
from handel_tpu_torch.sim import node  # the node imports the transport
try:
    QUICNetwork("127.0.0.1:0")
except ImportError as e:
    print("ImportError:", e)
"""


def test_without_cryptography_building_an_endpoint_names_the_package():
    out = subprocess.run([sys.executable, "-c", WITHOUT_CRYPTOGRAPHY], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ImportError:") and "`cryptography`" in out.stdout


def test_quic_localhost_run_beside_reference(tmp_path):
    """`network = "quic"` through both localhost platforms (fake scheme, 8
    nodes, two processes): both runs succeed with the same CSV columns."""
    import csv

    from handel_tpu.sim import config as rconfig
    from handel_tpu.sim.platform import LocalhostPlatform as RPlatform
    from handel_tpu_torch.sim import config as pconfig
    from handel_tpu_torch.sim.platform import LocalhostPlatform as PPlatform

    def run(mod, platform_cls, workdir):
        cfg = mod.SimConfig(network="quic", scheme="fake", max_timeout_s=60.0,
                            runs=[mod.RunConfig(nodes=8, threshold=6, processes=2)])
        res = asyncio.run(platform_cls(cfg, str(workdir)).start_run(0))
        if not res.ok:
            for out, err in res.outputs:
                print(out.decode(errors="replace"), err.decode(errors="replace"))
        assert res.ok
        with open(res.csv_path) as f:
            return list(csv.DictReader(f))[0]

    ours = run(pconfig, PPlatform, tmp_path / "port")
    theirs = run(rconfig, RPlatform, tmp_path / "ref")
    assert set(ours) == set(theirs)
    assert float(ours["net_sentPackets_sum"]) > 0
