"""Host-math device engine for the shared verifier — the `HostDevice` of
handel_tpu/service/driver.py.

`HostDevice` adapts host schemes (fake, BN254 reference math) to the
service's device contract so the WHOLE launch path — tenant queue, DRR
fairness, cross-session coalescing, fill accounting, breaker — runs
without a card: one `dispatch_multi` call is one "launch" whose lanes may
span sessions, messages and registries. Device schemes plug in their real
`BN254Device` instead (models/bn254_torch.py).

The reference's `MultiSessionCluster` and `run_service` (the `serve`
driver) are not ported yet, nor its RLC combined check (ROADMAP).
"""

from __future__ import annotations

import time

from handel_tpu_torch.models.bn254_torch import validate_batch_check


class HostDevice:
    """Device-shaped host verifier behind the shared service.

    `dispatch_multi(items)` — items are (msg, pubkeys, bitset, sig) — runs
    the scheme constructor's own batch_verify per (message, registry)
    group, synchronously (the service calls it in an executor thread), and
    returns the verdicts handle `fetch` hands back. `launch_ms` simulates
    a fixed device wall per launch (latency-shape experiments); 0 = as
    fast as the host math goes. `batch_check="rlc"` raises
    NotImplementedError: the port checks per candidate.
    """

    def __init__(self, constructor, batch_size: int = 64,
                 launch_ms: float = 0.0,
                 batch_check: str = "per_candidate"):
        self.constructor = constructor
        self.batch_size = batch_size
        self.launch_ms = launch_ms
        self.batch_check = validate_batch_check(batch_check)
        self.dispatched = 0
        # epoch-rotation protocol parity with the reference's BN254Device:
        # host verification reads per-request pubkeys so there is no
        # resident bank to flip, but the stage -> quiesce -> activate
        # choreography runs end to end
        self.epoch = 0
        self._staged = None
        self.registry_stagings = 0
        self.registry_staged_ms = 0.0

    def stage_registry(self, registry_pubkeys, build_prefix: bool = True) -> int:
        self._staged = registry_pubkeys
        self.registry_stagings += 1
        return len(registry_pubkeys)

    def activate_staged(self) -> int:
        if self._staged is None:
            raise RuntimeError("no staged registry: call stage_registry first")
        self._staged = None
        self.epoch += 1
        return self.epoch

    def dispatch_multi(self, items):
        verdicts = [False] * len(items)
        groups: dict[tuple, list[int]] = {}
        for i, (msg, pubkeys, _, _) in enumerate(items):
            groups.setdefault((msg, id(pubkeys)), []).append(i)
        for (msg, _), idxs in groups.items():
            pubkeys = items[idxs[0]][1]
            reqs = [(items[i][2], items[i][3]) for i in idxs]
            for i, ok in zip(
                idxs, self.constructor.batch_verify(msg, pubkeys, reqs)
            ):
                verdicts[i] = bool(ok)
        if self.launch_ms > 0:
            time.sleep(self.launch_ms / 1000.0)
        self.dispatched += 1
        return verdicts

    def fetch(self, handle):
        return handle
