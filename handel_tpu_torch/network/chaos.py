"""The chaos plane's configuration — the `ChaosConfig` dataclass of
handel_tpu/network/chaos.py, which sim/config.py parses from a `[chaos]`
TOML section.

The reference's `ChaosNetwork` (seeded per-link drop, corrupt, duplicate,
delay and reorder over any transport) is not ported yet (ROADMAP item 4):
a sim config that sets any rate raises in sim/node.py.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


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
