"""UDP distributed barrier for simulation runs — a copy of
handel_tpu/sim/sync.py.

Reference: simul/lib/sync.go:27-378 — slaves spam READY(state) datagrams with
their ids every 500 ms; the master counts distinct ids per state and releases
the barrier once it has seen 99.5% of the expected count (probabilistic
early release, sync.go:92-98,170, masking straggler datagram loss), then
acks every subsequent READY so late slaves unblock too. States: START, END.

Clock-offset piggyback: each READY carries the slave's send stamp
`ts`; a direct ack echoes it plus the master's receive-side stamp `mts`. The
slave then has a one-shot NTP-style sample — offset = mts - (ts + rtt/2),
bounded by ±rtt/2 — and keeps the estimate from the smallest-RTT exchange.
`sim/node.py` copies the START-barrier estimate onto the flight recorder so
`merge_traces` (core/trace.py) aligns multi-host timelines at export time,
and a swarm worker (swarm/worker.py) does the same for its block's recorder.
Bulk release acks (wait_all) carry no `ts` and never update the estimate.
"""

from __future__ import annotations

import asyncio
import json
import math
import time

STATE_START = 1
STATE_END = 2

RESEND_PERIOD = 0.5  # slave READY period (sync.go)
RELEASE_FRACTION = 0.995  # probabilistic early release (sync.go:92-98)


class _MasterProto(asyncio.DatagramProtocol):
    def __init__(self, master: "SyncMaster"):
        self.master = master

    def connection_made(self, transport):
        self.master._transport = transport

    def datagram_received(self, data: bytes, addr) -> None:
        try:
            msg = json.loads(data.decode())
        except ValueError:
            return
        ts = msg.get("ts")
        self.master._on_ready(
            int(msg["state"]),
            int(msg["id"]),
            addr,
            ts=float(ts) if ts is not None else None,
        )


class SyncMaster:
    """Barrier master expecting `expected` distinct ids per state
    (sync.go:163-260)."""

    def __init__(self, listen_port: int, expected: int):
        self.port = listen_port
        self.expected = expected
        self._transport = None
        self._seen: dict[int, set[int]] = {}
        self._released: dict[int, asyncio.Event] = {}
        self._addrs: dict[int, set] = {}

    def _event(self, state: int) -> asyncio.Event:
        if state not in self._released:
            self._released[state] = asyncio.Event()
        return self._released[state]

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        await loop.create_datagram_endpoint(
            lambda: _MasterProto(self), local_addr=("0.0.0.0", self.port)
        )

    def stop(self) -> None:
        if self._transport:
            self._transport.close()

    def _on_ready(
        self, state: int, node_id: int, addr, ts: float | None = None
    ) -> None:
        self._seen.setdefault(state, set()).add(node_id)
        self._addrs.setdefault(state, set()).add(addr)
        # ceil, not floor: for small fleets int() would release the barrier
        # one participant early (expected=2 -> int(1.99) = 1), letting a
        # block start gossiping before its sibling can even receive
        need = max(1, math.ceil(self.expected * RELEASE_FRACTION))
        if len(self._seen[state]) >= need:
            self._event(state).set()
        if self._event(state).is_set():
            # ack so the sender stops resending (and stragglers unblock);
            # echoing the slave's stamp + our own makes the exchange a
            # clock-offset sample on the slave side (module docstring)
            ack: dict = {"state": state, "ack": True}
            if ts is not None:
                ack["ts"] = ts
                ack["mts"] = time.time()
            self._transport.sendto(json.dumps(ack).encode(), addr)

    async def wait_all(self, state: int, timeout: float | None = None) -> None:
        await asyncio.wait_for(self._event(state).wait(), timeout)
        # ack everyone who already reported
        for addr in self._addrs.get(state, ()):
            self._transport.sendto(
                json.dumps({"state": state, "ack": True}).encode(), addr
            )


class _SlaveProto(asyncio.DatagramProtocol):
    def __init__(self, slave: "SyncSlave"):
        self.slave = slave

    def connection_made(self, transport):
        self.slave._transport = transport

    def datagram_received(self, data: bytes, addr) -> None:
        try:
            msg = json.loads(data.decode())
        except ValueError:
            return
        if msg.get("ack"):
            ts = msg.get("ts")
            if ts is not None and "mts" in msg:
                self.slave._offset_sample(float(ts), float(msg["mts"]))
            ev = self.slave._acked.get(int(msg["state"]))
            if ev:
                ev.set()


class SyncSlave:
    """Barrier participant (sync.go:263-344): signal readiness for a state
    and wait for the master's release ack."""

    def __init__(self, master_addr: str, node_id: int):
        host, _, port = master_addr.rpartition(":")
        self.master = (host or "127.0.0.1", int(port))
        self.node_id = node_id
        self._transport = None
        self._acked: dict[int, asyncio.Event] = {}
        # NTP-style clock estimate vs the master (module docstring): seconds
        # to ADD to our clock to land on the master's, plus the RTT of the
        # exchange that produced it (the estimate's ±rtt/2 error bound)
        self.clock_offset = 0.0
        self.clock_rtt = float("inf")

    def _offset_sample(self, ts: float, mts: float) -> None:
        rtt = time.time() - ts
        if rtt < 0.0 or rtt >= self.clock_rtt:
            return  # clock stepped backwards, or a noisier sample than kept
        self.clock_rtt = rtt
        self.clock_offset = mts - (ts + rtt / 2.0)

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        await loop.create_datagram_endpoint(
            lambda: _SlaveProto(self), remote_addr=self.master
        )

    def stop(self) -> None:
        if self._transport:
            self._transport.close()

    async def signal_and_wait(self, state: int, timeout: float | None = None) -> None:
        ev = self._acked.setdefault(state, asyncio.Event())

        async def spam():
            while not ev.is_set():
                # fresh `ts` per resend: every direct ack is a new offset
                # sample, and the min-RTT one wins (_offset_sample)
                self._transport.sendto(
                    json.dumps(
                        {"state": state, "id": self.node_id, "ts": time.time()}
                    ).encode()
                )
                await asyncio.sleep(RESEND_PERIOD)

        task = asyncio.get_running_loop().create_task(spam())
        try:
            await asyncio.wait_for(ev.wait(), timeout)
        finally:
            task.cancel()
