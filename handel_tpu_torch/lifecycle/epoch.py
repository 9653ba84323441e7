"""Epoch-based validator-set rotation over the shared verify plane — a copy
of handel_tpu/lifecycle/epoch.py.

A validator rotation is a steady-state event, not a restart:

    stage   `begin_rotation(pubkeys)` builds the NEXT registry bank on
            every lane engine — host pack, copy to the card, prefix-table
            scan — while the ACTIVE bank keeps serving launches
            (models/bn254_torch.py stage_registry; the work runs in
            executor threads, off the event loop, and on the card on a
            CUDA stream of its own, off the launch critical path)
    drain   `commit_rotation()` closes the collector's intake gate and
            waits for every in-flight launch to resolve — old-epoch work
            completes against the old bank, ZERO futures drop
    flip    with the plane idle, `activate_staged()` on every engine is a
            pointer swap; the epoch bumps on the service (new dedup keys),
            the session manager (new sessions version under it) and the
            trace plane, and the gate reopens

The measured gate-closed wall is `epoch_swap_stall_ms` (`values()`
`maxEpochSwapStallMs`): a rotation is "between launches", not a service
pause.
"""

from __future__ import annotations

import asyncio
from functools import partial

from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger


class EpochManager:
    """Stages, drains and flips validator-set epochs (module docstring).

    `service` is the shared `BatchVerifierService`; `manager` (optional)
    is the `SessionManager` whose future sessions version under the new
    epoch. Engines without the stage/activate protocol (plain stubs) are
    skipped — the epoch still bumps, which is all the dedup/versioning
    plane needs.
    """

    def __init__(self, service, manager=None, logger: Logger = DEFAULT_LOGGER):
        self.service = service
        self.manager = manager
        self.log = logger
        self.staged = False
        self.rotations = 0
        self.stagings = 0
        self.last_stall_ms = 0.0
        self.stall_ms: list[float] = []

    @property
    def epoch(self) -> int:
        return self.service.epoch

    async def begin_rotation(self, registry_pubkeys) -> int:
        """Stage `registry_pubkeys` as the next bank on every lane engine.
        Expensive by design — and therefore run in executor threads while
        the active bank keeps serving. Returns the number of engines
        staged. Re-staging before a commit replaces the pending set."""
        loop = asyncio.get_running_loop()
        staged = 0
        for lane in list(self.service.plane.lanes):
            eng = lane.engine
            if hasattr(eng, "stage_registry"):
                await loop.run_in_executor(
                    None, partial(eng.stage_registry, registry_pubkeys)
                )
                staged += 1
        self.staged = True
        self.stagings += 1
        self.log.info(
            "epoch_staged",
            f"staged next registry on {staged} engine(s) "
            f"(epoch {self.epoch} -> {self.epoch + 1})",
        )
        return staged

    async def commit_rotation(self) -> float:
        """Drain in-flight work and flip every staged bank live — the
        pointer swap between launches. Returns the stall in seconds (the
        gate-closed wall the swap cost). Queued-but-undispatched work
        verifies against the NEW set; futures are never dropped."""
        if not self.staged:
            raise RuntimeError("no staged rotation: call begin_rotation first")

        def flip() -> None:
            for lane in self.service.plane.lanes:
                eng = lane.engine
                if (
                    hasattr(eng, "activate_staged")
                    and getattr(eng, "_staged", None) is not None
                ):
                    eng.activate_staged()
            self.service.epoch += 1
            if self.manager is not None:
                self.manager.epoch = self.service.epoch

        stall = await self.service.quiesce_and(flip)
        self.staged = False
        self.rotations += 1
        self.last_stall_ms = stall * 1e3
        self.stall_ms.append(self.last_stall_ms)
        self.log.info(
            "epoch_committed",
            f"epoch {self.epoch} live after {self.last_stall_ms:.2f} ms "
            f"stall ({self.rotations} rotation(s))",
        )
        return stall

    async def rotate(self, registry_pubkeys) -> float:
        """stage + drain + flip in one call; returns the flip stall (s)."""
        await self.begin_rotation(registry_pubkeys)
        return await self.commit_rotation()

    def values(self) -> dict[str, float]:
        return {
            "epoch": float(self.epoch),
            "epochRotations": float(self.rotations),
            "epochStagings": float(self.stagings),
            "lastEpochSwapStallMs": self.last_stall_ms,
            "maxEpochSwapStallMs": max(self.stall_ms, default=0.0),
        }

    def gauge_keys(self) -> set[str]:
        return {"epoch", "lastEpochSwapStallMs", "maxEpochSwapStallMs"}
