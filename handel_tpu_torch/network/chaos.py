"""Deterministic fault-injection transport wrapper — a copy of
handel_tpu/network/chaos.py.

`ChaosNetwork` wraps ANY `Network` implementation (UDP/TCP sockets or the
in-process router, core/test_harness.py) and injects seeded per-link faults
on the outbound path:

  drop       the datagram vanishes (loss)
  corrupt    1-3 bytes of the payload are flipped — the receiver sees
             either an unparseable packet or a parseable-but-invalid
             signature, exercising both rejection paths
  duplicate  the datagram is delivered twice (dedup-cache fodder)
  delay      delivery is deferred by delay_ms ± jitter
  reorder    the datagram is held back and released after the NEXT send to
             the same link (with a flush timer so a quiet link cannot
             strand it)

Determinism: each (seed, destination address) link gets its own
`random.Random`, so fault placement depends only on the configured seed and
each link's own traffic order — never on cross-link interleaving or wall
time. The same seed gives the JAX package's fault pattern, byte for byte.

Counters ride the monitor plane through `values()`, merged over the inner
transport's own counters. `ChaosConfig` is the `[chaos]` TOML section
(sim/config.py).
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, replace
from typing import Sequence

from handel_tpu_torch.core.identity import Identity
from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger
from handel_tpu_torch.core.net import Listener, Packet
from handel_tpu_torch.core.trace import LogHistogram

# how long a reordered (held-back) packet may wait for the next send to its
# link before a timer flushes it anyway
REORDER_FLUSH_S = 0.05


@dataclass
class ChaosConfig:
    """Per-link fault rates (each in [0, 1]) + the determinism seed."""

    drop_rate: float = 0.0
    corrupt_rate: float = 0.0
    duplicate_rate: float = 0.0
    reorder_rate: float = 0.0
    delay_rate: float = 0.0
    delay_ms: float = 0.0
    delay_jitter_ms: float = 0.0
    seed: int = 0

    def any(self) -> bool:
        return any(
            r > 0.0
            for r in (
                self.drop_rate,
                self.corrupt_rate,
                self.duplicate_rate,
                self.reorder_rate,
                self.delay_rate,
            )
        )

    def validate(self) -> "ChaosConfig":
        for name in (
            "drop_rate",
            "corrupt_rate",
            "duplicate_rate",
            "reorder_rate",
            "delay_rate",
        ):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"chaos {name} must be in [0, 1], got {v}")
        return self

    def for_node(self, node_id: int) -> "ChaosConfig":
        """Derive a node-local config: same rates, node-unique seed — so
        every node's links fault independently but deterministically."""
        return replace(self, seed=self.seed * 1_000_003 + node_id)


class ChaosNetwork:
    """`Network` implementing seeded fault injection over an inner transport."""

    def __init__(
        self,
        inner,
        config: ChaosConfig,
        logger: Logger = DEFAULT_LOGGER,
    ):
        self.inner = inner
        self.cfg = config.validate()
        self.log = logger
        self._rngs: dict[str, random.Random] = {}
        self._held: dict[str, tuple[Identity, Packet]] = {}  # reorder slots
        # fault counters (monitor plane)
        self.dropped = 0
        self.corrupted = 0
        self.duplicated = 0
        self.delayed = 0
        self.reordered = 0
        # sampled-delay distribution (ms): delays were the one effect class
        # with no counter beyond a count — the histogram puts the injected
        # latency on the monitor plane (`net_delayMs_p50/_p90/_p99` CSV
        # columns, `sim watch`, trace reports). GeoNetwork records its
        # per-link WAN delays into the same histogram.
        self.hist_delay = LogHistogram()

    # -- lifecycle / listener passthrough -----------------------------------

    async def start(self) -> None:
        start = getattr(self.inner, "start", None)
        if start is not None:
            await start()

    def stop(self) -> None:
        # flush anything still held back so no packet is silently eaten by
        # teardown (the counters already recorded the reorder)
        for addr in list(self._held):
            self._flush_held(addr)
        stop = getattr(self.inner, "stop", None)
        if stop is not None:
            stop()

    def register_listener(self, listener: Listener) -> None:
        self.inner.register_listener(listener)

    # -- outbound fault pipeline ---------------------------------------------

    def send(self, identities: Sequence[Identity], packet: Packet) -> None:
        for ident in identities:
            self._send_one(ident, packet)

    def _rng(self, addr: str) -> random.Random:
        rng = self._rngs.get(addr)
        if rng is None:
            # string seeds hash through SHA-512 inside random.Random — stable
            # across processes and PYTHONHASHSEED values
            rng = random.Random(f"{self.cfg.seed}|{addr}")
            self._rngs[addr] = rng
        return rng

    def _send_one(self, ident: Identity, packet: Packet) -> None:
        cfg = self.cfg
        rng = self._rng(ident.address)

        if cfg.drop_rate and rng.random() < cfg.drop_rate:
            self.dropped += 1
            return
        if cfg.corrupt_rate and rng.random() < cfg.corrupt_rate:
            packet = self._corrupt(packet, rng)
            self.corrupted += 1
        copies = 1
        if cfg.duplicate_rate and rng.random() < cfg.duplicate_rate:
            copies = 2
            self.duplicated += 1

        for _ in range(copies):
            if cfg.reorder_rate and rng.random() < cfg.reorder_rate:
                self._hold(ident, packet)
                continue
            if cfg.delay_rate and rng.random() < cfg.delay_rate:
                delay_ms = cfg.delay_ms
                if cfg.delay_jitter_ms:
                    delay_ms += rng.uniform(
                        -cfg.delay_jitter_ms, cfg.delay_jitter_ms
                    )
                self.delayed += 1
                delay_ms = max(0.0, delay_ms)
                self.hist_delay.add(delay_ms)
                self._later(delay_ms / 1000.0, ident, packet)
                continue
            self._deliver(ident, packet)
            # a prior held-back packet is released AFTER this newer one:
            # that is the reorder
            self._flush_held(ident.address)

    def _deliver(self, ident: Identity, packet: Packet) -> None:
        self.inner.send([ident], packet)

    def _later(self, delay_s: float, ident: Identity, packet: Packet) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:  # no loop (sync test caller): deliver now
            self._deliver(ident, packet)
            return
        loop.call_later(delay_s, self._deliver, ident, packet)

    def _hold(self, ident: Identity, packet: Packet) -> None:
        self._flush_held(ident.address)  # at most one held packet per link
        self._held[ident.address] = (ident, packet)
        self.reordered += 1
        self._later_flush(ident.address)

    def _later_flush(self, addr: str) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._flush_held(addr)
            return
        loop.call_later(REORDER_FLUSH_S, self._flush_held, addr)

    def _flush_held(self, addr: str) -> None:
        held = self._held.pop(addr, None)
        if held is not None:
            self._deliver(*held)

    def _corrupt(self, packet: Packet, rng: random.Random) -> Packet:
        """Flip 1-3 bytes across the payload fields of a COPY — the original
        may be aliased by other destinations' deliveries."""
        ms = bytearray(packet.multisig)
        ind = bytearray(packet.individual_sig or b"")
        total = len(ms) + len(ind)
        if total == 0:
            return packet
        for _ in range(rng.randint(1, 3)):
            pos = rng.randrange(total)
            if pos < len(ms):
                ms[pos] ^= 1 << rng.randrange(8)
            else:
                ind[pos - len(ms)] ^= 1 << rng.randrange(8)
        return Packet(
            origin=packet.origin,
            level=packet.level,
            multisig=bytes(ms),
            individual_sig=bytes(ind) if ind else packet.individual_sig,
        )

    # -- reporter -------------------------------------------------------------

    def values(self) -> dict[str, float]:
        out = {
            "chaosDropped": float(self.dropped),
            "chaosCorrupted": float(self.corrupted),
            "chaosDuplicated": float(self.duplicated),
            "chaosDelayed": float(self.delayed),
            "chaosReordered": float(self.reordered),
        }
        if hasattr(self.inner, "values"):
            out.update(self.inner.values())
        return out

    def histograms(self) -> dict[str, LogHistogram]:
        """Distribution measures for the monitor's histogram plane
        (sim/monitor.py HistogramIO under the `net` plane name)."""
        out = {"delayMs": self.hist_delay}
        if hasattr(self.inner, "histograms"):
            out.update(self.inner.histograms())
        return out
