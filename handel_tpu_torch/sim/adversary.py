"""Adversarial node roles for simulation and test runs — a copy of
handel_tpu/sim/adversary.py.

These roles actively misbehave, each aimed at one hardening layer:

  invalid_signer   a full Handel node whose own contribution is garbage —
                   wrong-message signature bytes under a valid bitset. Every
                   aggregate it forwards fails the receiver's pairing check,
                   exercising failure attribution + peer penalties
                   (core/penalty.py) and negative-verdict dedup caching.
  stale_replayer   participates, but its periodic updates replay the FIRST
                   (lowest-weight) aggregate it ever saw per level instead
                   of its best combined signature — valid but useless
                   traffic that the dedup cache must absorb.
  flooder          packet storms at one level: bursts of parseable packets
                   with random signature bytes, each content-distinct, so
                   only the bounded pending queue (BatchProcessing
                   max_pending) and the ban threshold stop the growth.
  churner          dynamic membership (scenario engine): participates
                   HONESTLY until `leave_after_s`, then departs — stops
                   gossiping and fires `on_depart(node_id)` so the harness
                   can broadcast Handel.mark_departed to survivors, who
                   re-level around the hole and re-evaluate threshold
                   reachability. Not byzantine, but seated by the same
                   deterministic role machinery.

Role assignment (`adversary_roles`) is deterministic from the run config so
every node process computes the same mapping independently: adversaries take
the highest non-offline ids, invalid signers first.
"""

from __future__ import annotations

import asyncio
import random

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.handel import Handel
from handel_tpu_torch.core.net import Packet

ROLE_INVALID_SIGNER = "invalid_signer"
ROLE_STALE_REPLAYER = "stale_replayer"
ROLE_FLOODER = "flooder"
ROLE_CHURNER = "churner"
ROLES = (ROLE_INVALID_SIGNER, ROLE_STALE_REPLAYER, ROLE_FLOODER, ROLE_CHURNER)


def forged_signature(sk, msg: bytes):
    """A wrong-message signature: parseable, combinable, and guaranteed to
    fail verification for `msg`. For schemes whose signatures ignore the
    message entirely (the fake scheme), fall back to the scheme's explicit
    invalid-signature construction."""
    sig = sk.sign(b"forged:" + msg)
    if sig.marshal() == sk.sign(msg).marshal():
        # message-independent scheme: fake-style bool constructor
        return type(sig)(False)
    return sig


def adversary_roles(
    counts: dict[str, int], total: int, offline: set[int] | frozenset[int] = frozenset()
) -> dict[int, str]:
    """Deterministic node-id -> role mapping: highest non-offline ids,
    in ROLES order. Raises when the committee cannot seat them all."""
    roles: dict[int, str] = {}
    candidates = (i for i in range(total - 1, -1, -1) if i not in offline)
    for role in ROLES:
        for _ in range(int(counts.get(role, 0) or 0)):
            nid = next(candidates, None)
            if nid is None:
                raise ValueError(
                    f"cannot seat {counts} adversaries in a {total}-node "
                    f"committee with {len(offline)} offline"
                )
            roles[nid] = role
    return roles


def check_threshold_reachable(
    threshold: int,
    total: int,
    failing: int,
    roles: dict[int, str],
    *,
    weights=None,
    weight_threshold: float = 0.0,
    departed: frozenset[int] | set[int] = frozenset(),
) -> None:
    """Fail fast when the run can never complete: invalid signers contribute
    nothing countable (their signatures are rejected), churners and already-
    departed identities may leave before contributing, so the guaranteed
    honest supply is total - failing - invalid - churners - departed.

    With per-identity `weights` (indexed by node id) the check is on stake:
    the reachable weight is the surviving cohort's total minus the WORST
    CASE placement of the `failing` silent nodes — the heaviest survivors.
    `weight_threshold` 0.0 derives the same stake fraction the count
    threshold is of the node count."""
    gone = {
        i
        for i, r in roles.items()
        if r in (ROLE_INVALID_SIGNER, ROLE_CHURNER)
    }
    gone |= set(departed)
    if weights is None:
        reachable = total - failing - len(gone)
        if threshold > reachable:
            raise ValueError(
                f"threshold {threshold} unreachable: only {reachable} honest "
                f"contributions exist ({total} nodes - {failing} failing - "
                f"{len(gone)} invalid/departing)"
            )
        return
    w = [float(weights[i]) for i in range(total)]
    remaining = sorted((w[i] for i in range(total) if i not in gone),
                       reverse=True)
    lost_to_failing = sum(remaining[:failing]) if failing > 0 else 0.0
    reachable_w = sum(remaining) - lost_to_failing
    want = weight_threshold or (threshold * sum(w) / total)
    if want > reachable_w + 1e-9:
        raise ValueError(
            f"weighted threshold {want:.3f} unreachable: at most "
            f"{reachable_w:.3f} stake can contribute ({total} nodes, "
            f"{failing} failing worst-case, {len(gone)} invalid/departing)"
        )


class InvalidSigner(Handel):
    """A protocol-conformant node built on a forged own signature — the
    construction site (build_adversary / the test harness) swaps its own_sig
    for `forged_signature(...)`, and the normal gossip machinery does the
    rest: every aggregate that includes its contribution is invalid."""

    role = ROLE_INVALID_SIGNER


class StaleReplayer(Handel):
    """Freezes its outbound updates at the FIRST aggregate it could send per
    level — usually just its own signature — and replays that forever
    instead of its improving best. The replayed content is correctly scoped
    for its peers and verifies under any scheme (it is genuinely its own
    stale aggregate), so the traffic is valid-but-useless: the honest
    defense is the dedup cache, not a pairing rejection. (Replaying RECEIVED
    packets would instead be cross-subtree garbage — a level-l bitset only
    means anything to the subtree it was addressed to — i.e. a noisier
    invalid_signer, which is the other role's job.)"""

    role = ROLE_STALE_REPLAYER

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._stale: dict[int, bytes] = {}
        self.replayed_ct = 0

    def _send_update(self, lvl, count: int) -> None:
        stale = self._stale.get(lvl.id)
        if stale is None:
            ms = self.store.combined(lvl.id - 1)
            if ms is None:
                return
            stale = self._stale[lvl.id] = ms.marshal()
        peers = lvl.select_next_peers(count)
        if not peers:
            return
        self.msg_sent_ct += len(peers)
        self.replayed_ct += len(peers)
        self.net.send(
            peers, Packet(origin=self.id.id, level=lvl.id, multisig=stale)
        )

    def values(self) -> dict[str, float]:
        return {**super().values(), "advReplayedCt": float(self.replayed_ct)}


class Flooder(Handel):
    """Packet storm at one level: bursts of parseable, content-distinct
    packets (valid one-bit bitset + random signature bytes)."""

    role = ROLE_FLOODER

    def __init__(
        self,
        *args,
        flood_pps: float = 200.0,
        flood_level: int | None = None,
        flood_burst: int = 16,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.flood_pps = max(1.0, flood_pps)
        self.flood_burst = max(1, flood_burst)
        self.flood_level = flood_level
        self._flood_rng = random.Random(0xF100D ^ self.id.id)
        self._flood_task: asyncio.Task | None = None
        self.flooded_ct = 0

    def start(self) -> None:
        super().start()
        self._flood_task = asyncio.get_running_loop().create_task(
            self._flood_loop()
        )

    def stop(self) -> None:
        if self._flood_task is not None:
            self._flood_task.cancel()
            self._flood_task = None
        super().stop()

    def _flood_packet(self, level: int) -> Packet:
        size = len(self.levels[level].nodes)
        bs = BitSet(size)
        bs.set(self._flood_rng.randrange(size), True)
        wire = bs.marshal() + self._flood_rng.randbytes(
            self.cons.signature_size()
        )
        return Packet(origin=self.id.id, level=level, multisig=wire)

    async def _flood_loop(self) -> None:
        level = self.flood_level or max(self.levels)
        lvl = self.levels[level]
        interval = self.flood_burst / self.flood_pps
        pos = 0
        while True:
            for _ in range(self.flood_burst):
                peer = lvl.nodes[pos % len(lvl.nodes)]
                pos += 1
                self.net.send([peer], self._flood_packet(level))
                self.flooded_ct += 1
                self.msg_sent_ct += 1
            await asyncio.sleep(interval)

    def values(self) -> dict[str, float]:
        return {**super().values(), "advFloodedCt": float(self.flooded_ct)}


class Churner(Handel):
    """Honest until `leave_after_s`, then gone: cancels its own gossip and
    fires `on_depart(node_id)` (set post-construction by the harness) so
    survivors can `mark_departed` and re-level. The contribution it made
    BEFORE leaving stays valid in any aggregate that already merged it —
    departure removes future supply, not recorded history."""

    role = ROLE_CHURNER

    def __init__(self, *args, leave_after_s: float = 0.5, **kwargs):
        super().__init__(*args, **kwargs)
        self.leave_after_s = leave_after_s
        self.on_depart = None  # callable(node_id), wired by the harness
        self.left = False
        self._leave_handle: asyncio.TimerHandle | None = None

    def start(self) -> None:
        super().start()
        self._leave_handle = asyncio.get_running_loop().call_later(
            self.leave_after_s, self._depart
        )

    def _depart(self) -> None:
        if self.left:
            return
        self.left = True
        self._leave_handle = None
        self.stop()
        if self.on_depart is not None:
            self.on_depart(self.id.id)

    def stop(self) -> None:
        if self._leave_handle is not None:
            self._leave_handle.cancel()
            self._leave_handle = None
        super().stop()

    def values(self) -> dict[str, float]:
        return {**super().values(), "advLeftCt": float(self.left)}


ADVERSARY_CLASSES = {
    ROLE_INVALID_SIGNER: InvalidSigner,
    ROLE_STALE_REPLAYER: StaleReplayer,
    ROLE_FLOODER: Flooder,
    ROLE_CHURNER: Churner,
}


def build_adversary(
    role: str,
    network,
    registry,
    identity,
    constructor,
    msg: bytes,
    sk,
    config=None,
    *,
    flood_pps: float = 200.0,
    leave_after_s: float = 0.5,
):
    """Construct the adversarial node for `role` (Handel ctor signature,
    with the secret key in place of a pre-made own signature — the invalid
    signer forges its own)."""
    cls = ADVERSARY_CLASSES.get(role)
    if cls is None:
        raise ValueError(f"unknown adversary role {role!r} (known: {ROLES})")
    own_sig = (
        forged_signature(sk, msg)
        if role == ROLE_INVALID_SIGNER
        else sk.sign(msg)
    )
    kwargs = {}
    if role == ROLE_FLOODER:
        kwargs = {"flood_pps": flood_pps}
    elif role == ROLE_CHURNER:
        kwargs = {"leave_after_s": leave_after_s}
    return cls(
        network, registry, identity, constructor, msg, own_sig, config, **kwargs
    )
