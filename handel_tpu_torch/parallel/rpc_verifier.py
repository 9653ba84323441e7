"""Network batch-verification plane: chip-less hosts verify through the
card's host — a copy of handel_tpu/parallel/rpc_verifier.py.

In a multi-host run only the host holding the card can launch kernels, so
every other host's nodes ship their (bitset, signature) candidates to it
over a length-prefixed TCP protocol and get verdicts back; the card's host
fuses local and remote candidates into the same shared launches through its
BatchVerifierService (parallel/batch_verifier.py).

No external RPC dependency: frames are struct-packed, length-prefixed,
multiplexed by request id over one persistent connection per client
process — the same single-event-loop discipline as the rest of the runtime.
The wire format is the JAX package's, byte for byte, so either package's
client talks to either package's server.

Wire format (all big-endian):
  frame    := u32 body_len || body
  request  := u64 req_id || u32 msg_len || msg
              || u16 count || count * item
  item     := u32 bs_len || bitset.marshal() || u32 sig_len || sig.marshal()
  response := u64 req_id || u8 status || payload
              (status 0: payload = count verdict bytes 0/1;
               status 1: payload = utf-8 error text)

Faults: a dropped connection fails all in-flight futures; the caller
(core/processing.py BatchProcessing) requeues those candidates with its
per-candidate retry budget, and the client reconnects on the next verify
call — so a verifier-host restart degrades to retries, not node crashes.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Sequence

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.network.stream import TaskSet, frame

_MAX_FRAME = 64 << 20  # hard cap against a malformed/hostile length prefix


async def _read_frame(reader: asyncio.StreamReader) -> bytes:
    hdr = await reader.readexactly(4)
    (length,) = struct.unpack(">I", hdr)
    if length > _MAX_FRAME:
        raise ValueError(f"frame length {length} exceeds cap")
    return await reader.readexactly(length)


def _write_frame(writer: asyncio.StreamWriter, body: bytes) -> None:
    writer.write(frame(body))


def _pack_request(req_id: int, msg: bytes, requests) -> bytes:
    parts = [struct.pack(">QI", req_id, len(msg)), msg,
             struct.pack(">H", len(requests))]
    for bs, sig in requests:
        b, s = bs.marshal(), sig.marshal()
        parts.append(struct.pack(">I", len(b)))
        parts.append(b)
        parts.append(struct.pack(">I", len(s)))
        parts.append(s)
    return b"".join(parts)


def _unpack_request(body: bytes, constructor):
    req_id, msg_len = struct.unpack_from(">QI", body, 0)
    off = 12
    msg = body[off : off + msg_len]
    off += msg_len
    (count,) = struct.unpack_from(">H", body, off)
    off += 2
    requests = []
    for _ in range(count):
        (bs_len,) = struct.unpack_from(">I", body, off)
        off += 4
        bs, consumed = BitSet.unmarshal(body[off : off + bs_len])
        if consumed != bs_len:
            raise ValueError("bitset length mismatch in rpc item")
        off += bs_len
        (sig_len,) = struct.unpack_from(">I", body, off)
        off += 4
        sig = constructor.unmarshal_signature(body[off : off + sig_len])
        off += sig_len
        requests.append((bs, sig))
    return req_id, msg, requests


class VerifierServer:
    """Serves a local BatchVerifierService over TCP.

    Runs in the card host's node process (sim/node.py --serve-verifier):
    remote candidates join the local nodes' shared launch queue, so one
    card serves the whole fleet at full batch occupancy.
    """

    def __init__(self, service, constructor, host: str = "0.0.0.0",
                 port: int = 0):
        self.service = service  # BatchVerifierService (or any .verify)
        self.constructor = constructor
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None
        # monitor plane
        self.requests_served = 0
        self.candidates_served = 0
        self.errors = 0

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    def stop(self) -> None:
        if self._server:
            self._server.close()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        # one writer lock per connection: responses from concurrently
        # processed requests must not interleave mid-frame
        lock = asyncio.Lock()
        tasks = TaskSet()
        try:
            while True:
                try:
                    body = await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                tasks.spawn(self._serve_one(body, writer, lock))
        finally:
            tasks.cancel_all()
            writer.close()

    async def _serve_one(self, body: bytes, writer, lock) -> None:
        # recover req_id independently of full request parsing: an error
        # response under id 0 would resolve NO client future and leave the
        # sender's verify() awaiting forever
        req_id = (
            struct.unpack_from(">Q", body, 0)[0] if len(body) >= 8 else 0
        )
        try:
            req_id, msg, requests = _unpack_request(body, self.constructor)
            verdicts = await self.service.verify(msg, None, requests)
            payload = struct.pack(">QB", req_id, 0) + bytes(
                1 if v else 0 for v in verdicts
            )
            self.requests_served += 1
            self.candidates_served += len(requests)
        except Exception as e:  # malformed frame or device failure
            self.errors += 1
            payload = struct.pack(">QB", req_id, 1) + str(e).encode()[:512]
        async with lock:
            try:
                _write_frame(writer, payload)
                await writer.drain()
            except ConnectionError:
                pass  # client gone; its futures fail on their side

    def values(self) -> dict[str, float]:
        return {
            "rpcServedRequests": float(self.requests_served),
            "rpcServedCandidates": float(self.candidates_served),
            "rpcServeErrors": float(self.errors),
        }


class RPCVerifier:
    """AsyncVerifier client: ships candidate batches to a VerifierServer.

    Drop-in for Config.verifier (core/processing.py AsyncVerifier shape —
    the `pubkeys` argument is ignored; the server's device holds the
    registry). One persistent connection per process, multiplexed by
    request id; lazy (re)connect with a handful of quick retries so node
    startup races against the server's bind are absorbed.
    """

    def __init__(self, address: str, connect_retries: int = 20,
                 retry_delay: float = 0.5):
        host, _, port = address.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.connect_retries = connect_retries
        self.retry_delay = retry_delay
        self._writer: asyncio.StreamWriter | None = None
        self._reader_task: asyncio.Task | None = None
        self._inflight: dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._conn_lock = asyncio.Lock()
        # monitor plane
        self.requests_sent = 0
        self.candidates_sent = 0
        self.errors = 0

    async def _connect(self) -> None:
        last: Exception | None = None
        for _ in range(self.connect_retries):
            try:
                reader, writer = await asyncio.open_connection(
                    self.host, self.port
                )
                self._writer = writer
                self._reader_task = asyncio.get_running_loop().create_task(
                    self._read_loop(reader)
                )
                return
            except OSError as e:
                last = e
                await asyncio.sleep(self.retry_delay)
        raise ConnectionError(
            f"verifier server {self.host}:{self.port} unreachable: {last}"
        )

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                body = await _read_frame(reader)
                req_id, status = struct.unpack_from(">QB", body, 0)
                fut = self._inflight.pop(req_id, None)
                if fut is None or fut.done():
                    continue
                if status == 0:
                    fut.set_result([b == 1 for b in body[9:]])
                else:
                    fut.set_exception(
                        RuntimeError(
                            f"verifier server: {body[9:].decode(errors='replace')}"
                        )
                    )
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            ValueError,
            struct.error,  # body under 9 bytes: garbage on the port
        ) as e:
            # only the CURRENT connection's reader may tear down shared
            # state: a stale reader surviving a reconnect would otherwise
            # fail the new connection's futures and null the fresh writer
            if self._reader_task is asyncio.current_task():
                self._teardown(e)

    def _teardown(self, exc: Exception) -> None:
        """Drop the connection and fail everything that rode it. In-flight
        futures all belong to the dying connection (reconnect happens
        before new registrations), so failing them routes those candidates
        into BatchProcessing's retry path."""
        task = self._reader_task
        self._reader_task = None
        if task is not None and task is not asyncio.current_task():
            task.cancel()
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        self._fail_inflight(exc)

    def _fail_inflight(self, exc: Exception) -> None:
        self.errors += 1
        for fut in self._inflight.values():
            if not fut.done():
                fut.set_exception(ConnectionError(f"verifier link lost: {exc}"))
        self._inflight.clear()

    def stop(self) -> None:
        task = self._reader_task
        self._reader_task = None
        if task is not None:
            task.cancel()
        if self._writer:
            self._writer.close()
            self._writer = None

    async def verify(self, msg: bytes, pubkeys, requests) -> list[bool]:
        async with self._conn_lock:
            if self._writer is None:
                await self._connect()
            writer = self._writer
        self._next_id += 1
        req_id = self._next_id
        fut = asyncio.get_running_loop().create_future()
        self._inflight[req_id] = fut
        try:
            _write_frame(writer, _pack_request(req_id, msg, requests))
            await writer.drain()
        except (ConnectionError, OSError) as e:
            # the link is dead for every in-flight request, not just this
            # one — tear down so siblings fail fast into their retry path
            # instead of awaiting responses that will never arrive. Our own
            # future is popped first (we raise; nobody will await it)
            self._inflight.pop(req_id, None)
            self._teardown(e)
            raise ConnectionError(f"verifier send failed: {e}") from e
        self.requests_sent += 1
        self.candidates_sent += len(requests)
        return await fut

    @property
    def verifier(self):
        return self.verify

    def values(self) -> dict[str, float]:
        return {
            "rpcSentRequests": float(self.requests_sent),
            "rpcSentCandidates": float(self.candidates_sent),
            "rpcLinkErrors": float(self.errors),
        }
