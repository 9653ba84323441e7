"""Shared machinery for stream transports (TCP and the TLS/QUIC slot) — a
copy of handel_tpu/network/stream.py.

One place for the length-prefixed frame protocol (uint32 header + encoded
packet — TCP gives no message boundaries), the inbound read loop, and the
background-send task registry (asyncio keeps only weak refs to tasks, so a
fire-and-forget `create_task` can be garbage-collected mid-await; senders
must hold strong refs until completion).
"""

from __future__ import annotations

import asyncio
import struct

_LEN = struct.Struct(">I")
IDLE_TIMEOUT = 60.0  # reference's 1-minute conn deadline (tcp/net.go:100)


def frame(wire: bytes) -> bytes:
    return _LEN.pack(len(wire)) + wire


async def read_frames(reader, enc, listeners, log, tag: str, on_packet=None):
    """Length-prefixed read loop shared by every stream transport: decode
    each frame and fan out to listeners until EOF/idle-timeout/error."""
    try:
        while True:
            hdr = await asyncio.wait_for(
                reader.readexactly(_LEN.size), IDLE_TIMEOUT
            )
            (size,) = _LEN.unpack(hdr)
            data = await reader.readexactly(size)
            try:
                packet = enc.decode(data)
            except Exception as e:
                log.warn(f"{tag}_decode", e)
                continue
            if on_packet is not None:
                on_packet()
            for lst in listeners:
                lst.new_packet(packet)
    except (asyncio.IncompleteReadError, asyncio.TimeoutError, OSError):
        pass


class TaskSet:
    """Strong-reference holder for fire-and-forget send tasks."""

    def __init__(self):
        self._tasks: set[asyncio.Task] = set()

    def spawn(self, coro) -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    def cancel_all(self) -> None:
        for t in list(self._tasks):
            t.cancel()


class Session:
    """One live outbound session (a stream to a peer)."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer

    def alive(self) -> bool:
        return not self.writer.is_closing()

    def close(self) -> None:
        self.writer.close()


class SessionManager:
    """Per-peer session cache that dedups concurrent dials
    (quic/sessionmanager.go:11-93 `simpleSesssionManager`): while a dial to a
    peer is in flight, other senders await the same future instead of opening
    a second connection. Transport-agnostic via the dialer seam
    (quic/dialer.go) — TCP and TLS transports pass their own dialer."""

    def __init__(self, dialer):
        self._dialer = dialer  # async addr -> Session
        self._sessions: dict[str, Session] = {}
        self._waiting: dict[str, asyncio.Future] = {}  # isWaiting set

    async def session(self, addr: str) -> Session:
        ses = self._sessions.get(addr)
        if ses is not None and ses.alive():
            return ses
        fut = self._waiting.get(addr)
        if fut is not None:  # a dial is already in flight: piggyback
            return await asyncio.shield(fut)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._waiting[addr] = fut
        try:
            ses = await self._dialer(addr)
        except BaseException as e:
            fut.set_exception(e)
            # consume the exception if nobody else awaited the future
            fut.exception()
            raise
        finally:
            self._waiting.pop(addr, None)
        if not fut.done():
            fut.set_result(ses)
        self._sessions[addr] = ses
        return ses

    def drop(self, addr: str) -> None:
        ses = self._sessions.pop(addr, None)
        if ses is not None:
            ses.close()

    def close_all(self) -> None:
        for addr in list(self._sessions):
            self.drop(addr)
