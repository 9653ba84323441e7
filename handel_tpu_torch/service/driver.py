"""Host-math device engine for the shared verifier — the `HostDevice` of
handel_tpu/service/driver.py.

`HostDevice` adapts host schemes (fake, BN254 reference math) to the
service's device contract so the WHOLE launch path — tenant queue, DRR
fairness, cross-session coalescing, fill accounting, breaker — runs
without a card: one `dispatch_multi` call is one "launch" whose lanes may
span sessions, messages and registries. Device schemes plug in their real
`BN254Device` instead (models/bn254_torch.py).

The reference's `MultiSessionCluster` and `run_service` (the `serve`
driver) are not ported yet (ROADMAP item 8).
"""

from __future__ import annotations

import time

from handel_tpu_torch.models import rlc


class HostDevice:
    """Device-shaped host verifier behind the shared service.

    `dispatch_multi(items)` — items are (msg, pubkeys, bitset, sig) — runs
    the scheme constructor's own batch_verify per (message, registry)
    group, synchronously (the service calls it in an executor thread), and
    returns the verdicts handle `fetch` hands back. `launch_ms` simulates
    a fixed device wall per launch (latency-shape experiments); 0 = as
    fast as the host math goes.

    `batch_check="rlc"` switches the launch to the random-linear-
    combination combined check (models/rlc.py): one M+1-pairing equation
    over the whole launch, bisection with fresh scalars down to the
    per-candidate oracle when it fails. Schemes without an RLC ops table
    (the fake scheme) silently stay per-candidate.
    """

    def __init__(self, constructor, batch_size: int = 64,
                 launch_ms: float = 0.0,
                 batch_check: str = "per_candidate", rlc_rng=None):
        self.constructor = constructor
        self.batch_size = batch_size
        self.launch_ms = launch_ms
        self.batch_check = rlc.validate_batch_check(batch_check)
        self._rlc_rng = rlc_rng
        self._rlc_ops = (
            rlc.host_ops_for(constructor) if batch_check == "rlc" else None
        )
        self.rlc_stats = rlc.RlcStats()
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
        if self._rlc_ops is not None:
            verdicts = self._rlc_dispatch_multi(items)
        else:
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
            # per-candidate pairing cost, for the M+1 comparison: each
            # non-empty candidate is 2 Miller loops + 1 final exp
            live = sum(1 for it in items if it[2].cardinality() > 0)
            self.rlc_stats.miller_lanes += 2 * live
            self.rlc_stats.final_exp_lanes += live
        if self.launch_ms > 0:
            time.sleep(self.launch_ms / 1000.0)
        self.dispatched += 1
        return verdicts

    def _rlc_dispatch_multi(self, items):
        """RLC combined launch: aggregate each candidate's apk on the host,
        run one M+1-pairing check over every valid candidate (across
        message groups — that is the point), bisect on failure."""
        verdicts: list[bool] = [False] * len(items)
        cands: dict[int, tuple] = {}
        for i, (msg, pubkeys, bs, sig) in enumerate(items):
            if bs.cardinality() == 0 or getattr(sig, "point", None) is None:
                continue
            apk = self.constructor.aggregate_public_keys(pubkeys, bs)
            if getattr(apk, "point", None) is None:
                continue
            cands[i] = (msg, apk.point, sig.point)

        def combined(sub: list[int]) -> bool:
            return rlc.host_rlc_check(
                self._rlc_ops, [cands[i] for i in sub],
                rng=self._rlc_rng, stats=self.rlc_stats,
            )

        def oracle(i: int) -> bool:
            msg, pubkeys, bs, sig = items[i]
            self.rlc_stats.miller_lanes += 2
            self.rlc_stats.final_exp_lanes += 1
            return bool(
                self.constructor.batch_verify(msg, pubkeys, [(bs, sig)])[0]
            )

        for i, ok in rlc.bisect_verify(
            list(cands), combined, oracle, self.rlc_stats
        ).items():
            verdicts[i] = ok
        return verdicts

    def fetch(self, handle):
        return handle
